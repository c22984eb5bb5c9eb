"""How ``correct`` is decided: the plain reference judges what the window's
timed path produced.

After the window, a sample drawn from the seed — the longest file the
window finished and further files drawn from the seed until their chunks
are enough for the sample, and chunks of theirs, the longest among them —
is held to ``perfbench/reference/``:

- ``vad_chunks_off``: chunks of those files whose (start, end) differ from
  the reference's cut & merge of the same samples (exact: limit 0);
- ``beam_deficit``: on ``check.decode_chunks`` chunks, the mean over the
  chunks of the amount, in nats, by which the served tokens' summed
  reference log-prob (teacher-forced over the prompt and the served
  tokens, with the request's suppression) lies below that of the
  reference's own beam search of the chunk at the same beam and horizon
  (none where it lies above). A served token that the request suppresses
  counts 1e4 below its position's best;
- ``score_err``: on the same picks, the mean over the chunks of the
  absolute difference, in nats, between the program's own summed log-prob
  of the tokens it served (``FileRecord.scores``: the beam loop's
  ``sum_logprobs`` of the chunk's row, which the pipeline fetches with
  every batch) and the reference's teacher-forced summed log-prob of the
  same tokens, each step normalised over the tokens the request leaves
  (``reference/tokens.py:allowed``, which is the request's own mask: the
  non-speech symbols, every token from the end of text on, the language
  tokens among them, and at the first step the blank; a test holds the
  two equal). The same tokens are scored on both sides, so a near-tie that
  sends the beams elsewhere does not move it, as it moves ``beam_deficit``
  by ~20 nats at any precision: it reads the arithmetic along the path
  served, and so tells a bfloat16 decoder from an fp8 one, which
  ``beam_deficit`` cannot;
- ``word_err``: over the aligned chunks, the median of each chunk's mean
  word error, where a word's error is 1 if its text, start or end differs
  from the reference's (reference emissions at the padded length the
  program's align batch gives the chunk, reference trellis and walk), and
  otherwise the amount by which its score (the mean emission probability of
  its chars along the path, rounded to 3 digits as whisperX rounds it)
  differs from the reference's beyond one unit of that rounding. The median
  over chunks, as a chunk's walk can move a word by a frame where two
  placements tie to rounding (the emissions of random weights barely change
  over time), and then that chunk's words read as wrong;
- ``files_failed``: files whose output is incomplete or not allowed (a
  chunk without its horizon of tokens or with a token the request
  suppresses, a chunk without aligned words).

``judge`` returns each number beside its limit for the result line;
``readings`` also gives the control's numbers: the reference one precision
step lower in the program's place, on the same chunks: its own beam search
of each chunk (its ``score_err`` compares the control's own summed
log-prob of its hypothesis with the exact reference's score of the same
tokens), and its own emissions and walk.
"""

from __future__ import annotations

import numpy as np
import torch

from . import system as sysmod
from .traffic import SR, rng_for

N_SAMPLES = 30 * SR


def chunk_words(aligned: dict, n: int) -> list:
    """Each chunk's aligned words as (word, start, end, score), or None where
    the alignment fell back (no words, or a word without times). The
    transcripts are one sentence each, so ``align`` returns one segment per
    chunk, in order."""
    segs = aligned["segments"]
    if len(segs) != n:
        return [None] * n
    out = []
    for s in segs:
        ws = s.get("words") or []
        if not ws or any("start" not in w or "end" not in w for w in ws):
            out.append(None)
        else:
            out.append([(w["word"], w["start"], w["end"], w.get("score")) for w in ws])
    return out


def sample(seed: int, records: list, n_chunks: int, n_decode: int) -> tuple:
    """(check files, alignment picks, decoder picks), picks as (record, chunk
    index): the check files are the longest file the window finished and
    files drawn from the seed after it, until they hold as many chunks as
    the larger sample or the window has no other file (at least two where
    it has them); the alignment picks ``n_chunks`` and the decoder picks
    ``n_decode`` of their chunks, each drawn from the seed with the longest
    chunk among them."""
    rng = rng_for(seed, 3)
    by_index = {}
    for r in records:
        by_index.setdefault(r.index, r)
    uniq = list(by_index.values())
    longest = max(uniq, key=lambda r: (r.seconds, -r.order))
    others = [r for r in uniq if r is not longest]
    files = [longest] + [others[i] for i in rng.permutation(len(others))]
    need = max(n_chunks, n_decode)
    for n in range(1, len(files) + 1):
        if n >= 2 and sum(len(r.chunks) for r in files[:n]) >= need:
            break
    files = files[:n]

    def draw(n):
        pool = [(r, k) for r in files for k in range(len(r.chunks))]
        top = max(pool, key=lambda rk: rk[0].chunks[rk[1]][1] - rk[0].chunks[rk[1]][0])
        rest = [p for p in pool if p is not top]
        return [top] + [rest[i] for i in sorted(rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False))]

    return files, draw(n_chunks), draw(n_decode)


def _align_lengths(chunks: list) -> dict:
    """The padded sample length of each chunk's row in the program's align
    batches: rows sorted by length, batches of 8, padded to whole seconds."""
    lens = [max(400, int(e * SR) - int(s * SR)) for s, e in chunks]
    order = sorted(range(len(lens)), key=lambda i: lens[i])
    out = {}
    for b in range(0, len(order), 8):
        group = order[b : b + 8]
        pad = max(SR, -(-max(lens[i] for i in group) // SR) * SR)
        for i in group:
            out[i] = pad
    return out


class Reference:
    """The plain reference over the sampled chunks of one run."""

    def __init__(self, cfg: dict, seed: int, device: str):
        from reference import wav2vec2 as rw2v
        from reference import whisper as rw

        self.cfg, self.device = cfg, torch.device(device)
        self.wtree = sysmod.whisper_tree(cfg, seed, self.device)
        self.atree = sysmod.wav2vec2_tree(cfg, seed, self.device)
        self.rw, self.rw2v = rw, rw2v

    def mels(self, audio: np.ndarray, chunks: list) -> torch.Tensor:
        rows = np.zeros((len(chunks), N_SAMPLES), np.float32)
        for i, (s, e) in enumerate(chunks):
            clip = audio[int(s * SR) : int(e * SR)][:N_SAMPLES]
            rows[i, : len(clip)] = clip
        return self.rw.log_mel(torch.from_numpy(rows).to(self.device), self.cfg["whisper"]["num_mel_bins"])

    def model(self, precision: str):
        return self.rw.Whisper(self.wtree, self.cfg["whisper"], precision)

    def cross(self, model, mels: torch.Tensor) -> list:
        """Each decoder layer's cross-attention keys and values of the chunks,
        encoded a block of 8 chunks at a time."""
        parts = [model.cross_kv(model.encode(mels[b : b + 8])) for b in range(0, len(mels), 8)]
        return [tuple(torch.cat([p[i][j] for p in parts]) for j in range(2)) for i in range(len(parts[0]))]

    def scores(self, model, cross: list, served: torch.Tensor) -> torch.Tensor:
        """Each row's summed log-prob (B,) of the served tokens (B, steps),
        teacher-forced over the prompt and the served tokens with the
        request's suppression; a suppressed token counts 1e4 below its
        position's best."""
        from reference import tokens as rt

        w = self.cfg["whisper"]
        steps = served.shape[1]
        seq = torch.cat([torch.tensor(rt.prompt(w["vocab_size"]), device=self.device).expand(len(served), -1),
                         served[:, :-1]], dim=1)
        total = torch.zeros(len(served), device=self.device)
        for b in range(0, len(served), 8):
            logits = model.logits([(k[b : b + 8], v[b : b + 8]) for k, v in cross], seq[b : b + 8], steps)
            for s in range(steps):
                lp = rt.masked_log_probs(logits[:, s], w["vocab_size"], first=s == 0)
                got = torch.gather(lp, -1, served[b : b + 8, s, None])[:, 0]
                total[b : b + 8] += torch.maximum(got, lp.amax(dim=-1) - 1e4)
        return total

    def beam(self, model, cross: list) -> tuple:
        """The reference's own beam search of each chunk at the
        configuration's beam and horizon: (B, steps) tokens and their summed
        log-prob (B,) as ``model`` scores them."""
        from reference import tokens as rt

        w, d = self.cfg["whisper"], self.cfg["decode"]
        V = w["vocab_size"]
        return model.beam_search(cross, rt.prompt(V), d["beam_size"], d["max_new_tokens"],
                                 lambda logits, first: rt.masked_log_probs(logits, V, first))

    def words(self, precision: str, audio: np.ndarray, chunk: tuple, padded: int, text: str):
        from reference import ctc

        s, e = round(chunk[0], 3), round(chunk[1], 3)
        clip = audio[int(s * SR) : int(e * SR)]
        n = max(len(clip), 400)
        row = np.zeros((1, padded), np.float32)
        row[0, : len(clip)] = clip
        model = self.rw2v.Wav2Vec2(self.atree, self.cfg["wav2vec2"], precision)
        lp = model.log_probs(torch.from_numpy(row).to(self.device), [n])[0]
        frames = self.rw2v.frames(n, self.cfg["wav2vec2"])
        return ctc.words(text, sysmod.dictionary(), lp[:frames].double().cpu().numpy(), s, e)


def _word_errs(got, want) -> list:
    """Each word's error (see the module docstring), and 1 for every word
    where one side has no alignment or other words."""
    if got is None or want is None or [w[0] for w in got] != [w[0] for w in want]:
        return [1.0] * len(want or got or [None])
    return [1.0 if (a[1], a[2]) != (b[1], b[2]) else max(0.0, abs(a[3] - b[3]) - 0.001 - 1e-9) for a, b in zip(got, want)]


def _decoder_readings(ref: Reference, files: list, ref_chunks: dict, dec: list, horizon: int, control: dict,
                      precisions) -> dict:
    """Each decoder pick's ``beam_deficit`` and ``score_err`` (see the module
    docstring) of the served tokens and the program's scores ("exact") and
    of the control's own beam search and its own scores ("control"). No
    pick: one reading of 1e4 each, which fails."""
    if not dec:
        return {n: {p: [1e4] for p in precisions} for n in ("beam_deficit", "score_err")}
    mels = torch.cat([ref.mels(files[r.index].audio, [ref_chunks[r.index][k]]) for r, k in dec])
    served = torch.tensor([r.tokens[k] if len(r.tokens[k]) == horizon else [0] * horizon for r, k in dec],
                          device=ref.device)
    exact = ref.model("exact")
    cross = ref.cross(exact, mels)
    best = ref.scores(exact, cross, ref.beam(exact, cross)[0])
    got = {"exact": ref.scores(exact, cross, served)}
    own = {"exact": torch.tensor([r.scores[k] for r, k in dec], dtype=torch.float64)}
    if "control" in precisions:
        low = ref.model(control["whisper"])
        hyp, own["control"] = ref.beam(low, ref.cross(low, mels))
        del low
        got["control"] = ref.scores(exact, cross, hyp)
    return {"beam_deficit": {p: (best - g).clamp(min=0).tolist() for p, g in got.items()},
            "score_err": {p: (own[p].double().cpu() - g.double().cpu()).abs().tolist() for p, g in got.items()}}


def readings(cell, seed: int, files: list, records: list, device: str, precisions=("exact",),
             with_detail: bool = False) -> dict:
    """The check's numbers for the program (``exact``: the program's outputs
    against the reference) and, with "control" among ``precisions``, the
    control's: the reference with the configuration's ``check.control``
    precision of each model in the program's place (its own beam search of
    each chunk; its own emissions and walk) on the same chunks."""
    import reference
    from reference import tokens as rt
    from reference import vad as rvad

    cfg = cell.config
    control = cfg["check"]["control"]
    horizon = cfg["decode"]["max_new_tokens"]
    check_files, picks, dec = sample(seed, records, cfg["check"]["chunks"], cfg["check"]["decode_chunks"])
    out = {p: {} for p in precisions}
    detail = {p: {} for p in precisions}
    vocab = cfg["whisper"]["vocab_size"]
    ok_first, ok = rt.allowed(vocab, first=True).numpy(), rt.allowed(vocab, first=False).numpy()

    def served_well(t):  # the horizon's length, and no token the request suppresses
        return len(t) == horizon and ok_first[t[0]] and bool(ok[np.asarray(t[1:], np.int64)].all())

    out["exact"]["files_failed"] = sum(
        1 for r in records
        if not r.chunks or not all(served_well(t) for t in r.tokens) or any(w is None for w in r.words)
    )
    with reference.precision():
        ref_chunks, off = {}, 0
        for r in check_files:
            ref_chunks[r.index] = rvad.chunks(files[r.index].audio)
            want = [(round(s, 3), round(e, 3)) for s, e in ref_chunks[r.index]]
            got = [(round(s, 3), round(e, 3)) for s, e in r.chunks]
            off += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        out["exact"]["vad_chunks_off"] = off
        # Reference chunk k stands for the program's chunk k (they are equal
        # where vad_chunks_off reads 0).
        picks = [(r, k) for r, k in picks if k < len(ref_chunks[r.index])]
        dec = [(r, k) for r, k in dec if k < len(ref_chunks[r.index])]
        ref = Reference(cfg, seed, device)
        dr = _decoder_readings(ref, files, ref_chunks, dec, horizon, control, precisions)
        for prec in precisions:
            d, e = dr["beam_deficit"][prec], dr["score_err"][prec]
            out[prec]["beam_deficit"], out[prec]["score_err"] = float(np.mean(d)), float(np.mean(e))
            detail[prec]["decoder"] = {"chunks": len(d), "deficits": d, "moved": int(sum(x > 0.01 for x in d)),
                                       "score_errs": e}

        errs = {p: [] for p in precisions}
        for r, k in picks:
            full = ref_chunks[r.index]
            padded = _align_lengths([(round(s, 3), round(e, 3)) for s, e in full])
            audio = files[r.index].audio
            want = ref.words("exact", audio, full[k], padded[k], r.texts[k])
            for prec in precisions:
                got = r.words[k] if prec == "exact" else ref.words(control["wav2vec2"], audio, full[k], padded[k], r.texts[k])
                errs[prec].append(_word_errs(got, want))
        for prec in precisions:
            out[prec]["word_err"] = float(np.median([np.mean(e) for e in errs[prec]]))
            detail[prec]["words"] = {"chunk_means": [float(np.mean(e)) for e in errs[prec]],
                                     "moved": int(sum(x == 1.0 for e in errs[prec] for x in e))}
    if with_detail:
        return out, detail
    return out


def judge(cell, seed: int, files: list, records: list, device: str) -> dict:
    """``correct`` and each number beside its limit."""
    values = readings(cell, seed, files, records, device)["exact"]
    limits = cell.config["check"]["limits"]
    numbers = {name: {"value": values[name], "limit": limits[name]} for name in limits}
    correct = all(n["value"] <= n["limit"] for n in numbers.values())
    return {"correct": correct, "failed": values["files_failed"], "numbers": numbers}

"""A run with the timed path broken underneath comes out not correct: one
run for each fault the cells can have, at the tiny CPU size, the harness's
look for a card skipped."""

import numpy as np
import pytest
import torch

import tiny
from benchlib import runner


def run():
    # Files of 3 and 4 minutes: 6 and 8 chunks, so that half of a decode batch holds chunks.
    return runner.run(tiny.cell(minutes=(3.0, 4.0)), 17, 2.0, False, "cpu", log=lambda m: None)


def test_sound_run_is_correct():
    line = run()
    assert line["correct"] is True


def altered_token(monkeypatch):
    """A served token altered where the decoder's tokens become text: each
    chunk's first token replaced by one the request suppresses."""
    from whisperx_tpu_torch.decode.engine import WhisperEngine

    decode = WhisperEngine.decode_text

    def broken(self, result):
        toks = np.array(result.tokens)
        toks[:, 0] = ord('"')
        result._tokens = toks
        return decode(self, result)

    monkeypatch.setattr(WhisperEngine, "decode_text", broken)


def half_batch_left_out(monkeypatch):
    """Half of every decode batch left out: its rows come back empty."""
    from whisperx_tpu_torch.decode.engine import WhisperEngine

    generate = WhisperEngine.generate

    def broken(self, mel, **kw):
        res = generate(self, mel, **kw)
        toks = res.tokens.copy()
        toks[toks.shape[0] // 2 :] = self.tokenizer.eot
        res._tokens = toks
        return res

    monkeypatch.setattr(WhisperEngine, "generate", broken)


def altered_word_time(monkeypatch):
    """An answer altered where it is produced: each segment's first word
    starts 0.1 s late."""
    from whisperx_tpu_torch.align import alignment

    aggregate = alignment._aggregate_result

    def broken(*a, **kw):
        out = aggregate(*a, **kw)
        for seg in out["segments"]:
            if seg.get("words"):
                seg["words"][0]["start"] = round(seg["words"][0]["start"] + 0.1, 3)
        return out

    monkeypatch.setattr(alignment, "_aggregate_result", broken)


def altered_emissions(monkeypatch):
    """The emissions altered where they are produced: the CTC head's log-probs
    sharpened by 5%."""
    from whisperx_tpu_torch.align import alignment

    emissions = alignment._emissions

    def broken(model, wavs, lens):
        lp, n = emissions(model, wavs, lens)
        return torch.log_softmax(1.05 * lp, dim=-1), n

    monkeypatch.setattr(alignment, "_emissions", broken)


def altered_chunk(monkeypatch):
    """A VAD chunk altered: each file's first chunk ends half a second early."""
    from whisperx_tpu_torch.vad.model import VadPipeline

    call = VadPipeline.__call__

    def broken(self, audio, chunk_size=30.0):
        out = call(self, audio, chunk_size)
        if out:
            out[0] = dict(out[0], end=out[0]["end"] - 0.5)
        return out

    monkeypatch.setattr(VadPipeline, "__call__", broken)


def altered_score(monkeypatch):
    """The program's score of each chunk altered where the benchmark reads
    it: every row's summed log-prob shifted by twice the ``score_err`` limit."""
    from whisperx_tpu_torch.decode.engine import DecodeResult

    shift = 2 * tiny.cell().config["check"]["limits"]["score_err"]
    monkeypatch.setattr(DecodeResult, "sum_logprobs", property(lambda self: self.fetch()._stats[0] + shift))


@pytest.mark.parametrize("fault,number", [
    (altered_token, "beam_deficit"),
    (half_batch_left_out, "files_failed"),
    (altered_word_time, "word_err"),
    (altered_emissions, "word_err"),
    (altered_chunk, "vad_chunks_off"),
    (altered_score, "score_err"),
])
def test_fault_comes_out_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    line = run()
    assert line["correct"] is False
    assert line["check"][number]["value"] > line["check"][number]["limit"]

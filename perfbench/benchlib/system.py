"""The system under test: the port's pipeline, built as ``load_model`` and
``load_align_model`` build it, holding the benchmark's seeded weights.

``load_model`` reads a checkpoint directory; the benchmark has none, so it
builds the same objects from the port's classes (``Whisper`` →
``WhisperEngine`` → ``WhisperPipeline`` with ``load_vad_model``'s default
VAD; ``Wav2Vec2ForCTC`` → ``AlignModel``) with ``load_model``'s choices for
the configuration's ``compute_type`` (bf16 compute, fused QKV, int8 weights
and int8 KV cache for "int8"; bf16 weights and a bf16 cache for "float16"),
and copies the weights in with a strict ``load_state_dict``.

The timed path of one file is the user's: ``load_audio(path)`` →
``transcribe(audio, batch_size)`` → ``align(segments, ...)``. The
benchmark keeps each decode batch's ``DecodeResult`` of the file in flight
as the pipeline receives it, so that ``scores`` reads the program's own
summed log-prob of every chunk from the host copies the pipeline has
already fetched.
"""

from __future__ import annotations

import torch

from . import weights

# Each token id prints as one character of Unicode's supplementary planes,
# so that a transcript reads back as the token ids the decoder served.
ID_BASE = 0x10000


class IdBackend:
    """A tokenizer backend whose decode is one character per id. Encoding
    is the byte codec's (one id per UTF-8 byte), which sets the default
    non-speech suppression and the blank token as it does for that codec."""

    def __init__(self, n_vocab: int):
        self.n_vocab = n_vocab

    def encode(self, text: str) -> list:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return "".join(chr(ID_BASE + int(i)) for i in ids)

    def id_to_piece(self, i: int) -> str:
        return chr(ID_BASE + i)


def served_ids(text: str) -> list:
    return [ord(c) - ID_BASE for c in text]


# wav2vec2-base-960h's vocabulary (facebook/wav2vec2-base-960h vocab.json).
W2V_VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "|", "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U", "M",
             "W", "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X", "J", "Q", "Z"]


def dictionary() -> dict:
    return {c.lower(): i for i, c in enumerate(W2V_VOCAB)}


def whisper_tree(config: dict, seed: int, device) -> dict:
    quantized = config["compute_type"] == "int8"
    leaves = weights.whisper_leaves(config["whisper"], quantized=quantized, fused_qkv=True)
    return weights.draw(leaves, seed, device, int8=quantized, int8_sigma=config["weights"]["int8_sigma"],
                        bf16=not quantized, stream=1)


def wav2vec2_tree(config: dict, seed: int, device) -> dict:
    leaves = weights.wav2vec2_leaves(config["wav2vec2"], config["weights"]["emission_scale"])
    return weights.draw(leaves, seed, device, int8=False, int8_sigma=1.0, bf16=True, stream=3)


class System:
    """The pipeline and align model of ``config`` on ``device``."""

    def __init__(self, config: dict, seed: int, device: str):
        from whisperx_tpu_torch.align.alignment import AlignModel
        from whisperx_tpu_torch.decode.engine import WhisperEngine
        from whisperx_tpu_torch.decode.tokenizer import WhisperTokenizer
        from whisperx_tpu_torch.models.convert import wav2vec2_config_from_hf, whisper_config_from_hf
        from whisperx_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
        from whisperx_tpu_torch.models.whisper import Whisper
        from whisperx_tpu_torch.pipeline.asr import TranscriptionOptions, WhisperPipeline
        from whisperx_tpu_torch.vad.model import load_vad_model

        self.config, self.device = config, torch.device(device)
        ct = config["compute_type"]
        if ct not in ("int8", "float16"):
            raise ValueError(f"compute_type {ct!r}: the benchmark builds int8 or float16 pipelines")
        dec = config["decode"]
        wcfg = whisper_config_from_hf(config["whisper"])
        model = Whisper(wcfg, dtype=torch.bfloat16, quantized=ct == "int8", quant_bits=8, fused_qkv=True,
                        attn_impl="auto", device=self.device)
        model.load_state_dict(whisper_tree(config, seed, self.device), strict=True)
        tok = WhisperTokenizer(IdBackend(wcfg.n_vocab), wcfg.n_vocab, wcfg.num_languages, language="en", task="transcribe")
        suppress = (-1, tok.eot) if dec["ban_eot"] else (-1,)
        vad_opts = {"vad_onset": config["vad"]["onset"], "vad_offset": config["vad"]["offset"]}
        self.pipe = WhisperPipeline(
            engine=WhisperEngine(model, tok), vad=load_vad_model(self.device, **vad_opts), vad_params=vad_opts,
            options=TranscriptionOptions(beam_size=dec["beam_size"], max_new_tokens=dec["max_new_tokens"],
                                         suppress_tokens=suppress),
            tokenizer=tok, language="en", kv_cache_dtype="int8" if ct == "int8" else "model",
        )
        # transcribe hands each decode batch's DecodeResult, as generate
        # returns it, to _gathered: keep them for ``scores``.
        kept = self.decoded = []
        gathered = self.pipe._gathered

        def gathered_kept(result):
            kept.append(gathered(result))
            return kept[-1]

        self.pipe._gathered = gathered_kept
        w2v = Wav2Vec2ForCTC(wav2vec2_config_from_hf(config["wav2vec2"]),
                             dtype=torch.bfloat16 if self.device.type == "cuda" else torch.float32,
                             attn_impl="auto", device=self.device)
        w2v.load_state_dict(wav2vec2_tree(config, seed, self.device), strict=True)
        self.align_model = AlignModel(model=w2v, dictionary=dictionary(), language="en", blank_id=0)
        self.metadata = {"language": "en", "dictionary": self.align_model.dictionary, "type": "torch"}

    def load(self, path: str):
        import whisperx_tpu_torch

        return whisperx_tpu_torch.load_audio(path)

    def transcribe(self, audio):
        self.decoded.clear()
        return self.pipe.transcribe(audio, batch_size=self.config["decode"]["batch_size"])

    def scores(self, n_chunks: int) -> list:
        """The program's summed log-prob of each of the last file's
        ``n_chunks`` chunks, in chunk order: row k % batch of decode batch
        k // batch (``DecodeResult.sum_logprobs``, which the pipeline has
        already copied to the host: no device work, no wait)."""
        batch = self.config["decode"]["batch_size"]
        return [float(self.decoded[k // batch].sum_logprobs[k % batch]) for k in range(n_chunks)]

    def align(self, segments, audio):
        import whisperx_tpu_torch

        return whisperx_tpu_torch.align(segments, self.align_model, self.metadata, audio, self.device)

    def stage_seconds(self) -> dict:
        """The program's stage timers: ``vad`` and ``asr_decode`` of the
        pipeline, ``align`` of the process-wide collector."""
        from whisperx_tpu_torch.utils import telemetry

        out = {"align": telemetry.GLOBAL.stages["align"].seconds} if "align" in telemetry.GLOBAL.stages else {}
        for k in ("vad", "asr_decode"):
            if k in self.pipe.telemetry.stages:
                out[k] = self.pipe.telemetry.stages[k].seconds
        return out

    def close(self) -> None:
        """Drop the models (and the decode loop they keep) and free the card."""
        import gc

        self.pipe = self.align_model = None
        self.decoded.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

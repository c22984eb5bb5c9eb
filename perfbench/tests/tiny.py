"""A cell at tiny widths for the CPU tests: the configuration of a real cell
with its widths, depths and file lengths cut, so that a whole run (set-up,
window, check) takes seconds on the CPU with the program's plain versions."""

from __future__ import annotations

import copy

from benchlib import spec

TINY_WHISPER = {"d_model": 64, "encoder_layers": 2, "decoder_layers": 2, "encoder_attention_heads": 2,
                "decoder_attention_heads": 2, "encoder_ffn_dim": 256, "decoder_ffn_dim": 256}
TINY_W2V = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 128,
            "conv_dim": [32] * 7, "num_conv_pos_embedding_groups": 4}


def cell(name: str = "large-v2-int8.longform-dense", horizon: int = 6, minutes=(0.5, 1.0)) -> spec.Cell:
    c = spec.load_cell(name)
    c = copy.deepcopy(c)
    c.config["whisper"].update(TINY_WHISPER)
    c.config["wav2vec2"].update(TINY_W2V)
    c.config["decode"]["max_new_tokens"] = horizon
    c.config["check"]["chunks"] = 4
    c.config["check"]["decode_chunks"] = 3
    c.traffic["file_minutes"] = list(minutes)
    c.traffic["warmup_minutes"] = min(c.traffic["warmup_minutes"], minutes[0])
    return c

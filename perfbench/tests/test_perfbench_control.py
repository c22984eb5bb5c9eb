"""On the card, at each cell's own size: the control (the reference one
precision step lower in the program's place) fails one of the check's
numbers (the decoder's, ``score_err``, among them) while the program passes
them all, on three seeds; and a decode loop whose step leaves its state
unchanged comes out not correct.

    python -m pytest perfbench/tests/test_perfbench_control.py   # on a machine with a card
"""

import numpy as np
import pytest

import control
from benchlib import runner, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check_and_the_program_passes(card, name):
    cell = spec.load_cell(name)
    limits = cell.config["check"]["limits"]
    for seed in (901, 902, 903):
        r = control.readings(cell, seed, 16.0, card, lambda m: None)  # 16 s: files enough for the whole sample
        assert all(r["program"][k] <= limits[k] for k in limits), r
        assert any(r["control"][k] > limits[k] for k in limits if k in r["control"]), r
        assert r["control"]["score_err"] > limits["score_err"], r  # the decoder's control fails on the scores


@pytest.mark.cuda
def test_frozen_decode_loop_is_not_correct(card, monkeypatch):
    from whisperx_tpu_torch.decode.engine import WhisperEngine

    generate = WhisperEngine.generate

    def frozen(self, mel, **kw):  # every position repeats the first token served
        res = generate(self, mel, **kw)
        toks = np.array(res.tokens)
        toks[:] = toks[:, :1]
        res._tokens = toks
        return res

    monkeypatch.setattr(WhisperEngine, "generate", frozen)
    cell = spec.load_cell(CELLS[0])
    line = runner.run(cell, 904, 5.0, False, card, log=lambda m: None)
    assert line["correct"] is False
    assert line["check"]["beam_deficit"]["value"] > line["check"]["beam_deficit"]["limit"]

"""``score_err`` at the tiny size on the CPU: it compares like with like
(the request's mask is the reference's), reads bfloat16 rounding for the
program, and reads the fp8 reference, scored by the same function, above
it."""

import numpy as np
import pytest

import tiny
from benchlib import check, runner, system
from reference import tokens as rt


@pytest.mark.parametrize("n_vocab", [51865, 51866])
def test_the_request_mask_is_the_reference_mask(n_vocab):
    from whisperx_tpu_torch.decode import search

    cfg = tiny.cell().config
    cfg["whisper"]["vocab_size"] = n_vocab
    pipe = system.System(cfg, 3, "cpu").pipe
    opts, _ = pipe._search_options(pipe.tokenizer)  # the request as transcribe builds it
    later = search._static_suppress_mask(n_vocab, opts) == 0
    first = later & (search._first_step_mask(n_vocab, opts) == 0)
    assert np.array_equal(later, rt.allowed(n_vocab, first=False).numpy())
    assert np.array_equal(first, rt.allowed(n_vocab, first=True).numpy())
    assert pipe.tokenizer.sot_sequence(without_timestamps=True) == rt.prompt(n_vocab)


@pytest.mark.parametrize("compute_type", ["float16", "int8"])
def test_score_err_reads_bf16_rounding_and_fp8_above_it(tmp_path, compute_type):
    # A window of exactly one 10-minute file (20 chunks), whatever the CPU's
    # speed: a window of 0 s ends with its first file.
    cell = tiny.cell(minutes=(10.0,))
    cell.config["compute_type"] = compute_type
    cell.config["check"]["control"]["whisper"] = "fp8"
    session = runner.Session(cell, 2**31 + 5, "cpu", str(tmp_path), lambda m: None)
    record = session.window(0.0, False)
    assert len(record.files) == 1 and len(record.files[0].chunks) == 20
    out = check.readings(cell, 2**31 + 5, session.files, record.files, "cpu", ("exact", "control"))
    program, fp8 = out["exact"]["score_err"], out["control"]["score_err"]
    # bfloat16 rounding: under one unit in the 8th bit a served token.
    assert 0 < program < cell.config["decode"]["max_new_tokens"] * 2**-8
    assert fp8 > 4 * program

"""A run prints one well-formed line at a tiny size on the CPU, and the
command refuses cleanly where it cannot run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import tiny
from benchlib import runner, spec

ROOT = str(spec.ROOT)


def command(*args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = command("--workload", "large-v2-int8.longform-dense", "--seed", "1", "--seconds", "5", "--trace", "0",
                  env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench")
    out = command("--workload", "large-v2-int8.longform-dense", "--seed", "1", "--seconds", "5", cwd=tmp_path,
                  env={"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cpu_run_line(traced):
    cell = tiny.cell()
    logs = []
    line = runner.run(cell, 2**31 + 3, 3.0, traced, "cpu", log=logs.append)
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"  # never a device's name for a CPU run
    names = {m["name"]: m for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(line["metrics"]) <= set(names)
    for name, m in line["metrics"].items():
        assert m["unit"] == names[name]["unit"] and m["value"] > 0
        assert names[name]["source"] != "device_trace"  # the CPU has no device trace to read
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        assert set(line["metrics"]) == set(names) - {"peak_mem_gib"}  # device memory: on a card only
    for n in line["check"].values():
        assert n["value"] <= n["limit"]
    # Each number compared, beside its limit: the configuration's limits, the last lines of standard error.
    limits = cell.config["check"]["limits"]
    assert list(line["check"]) == list(limits)
    assert [m.split(":")[0] for m in logs[-len(limits):]] == [f"check {name}" for name in limits]


def test_sparse_traffic_runs_on_the_cpu():
    cell = tiny.cell("large-v2-int8.sparse-speech", minutes=(3.0, 4.0))
    line = runner.run(cell, 5, 2.0, False, "cpu", log=lambda m: None)
    assert line["correct"] is True and line["check"]["vad_chunks_off"]["value"] == 0

"""Audio of the benchmark's traffic mixes for the port's tests: the files
that ``perfbench/benchlib/traffic.py`` (the benchmark's one generator, numpy
only) makes from a traffic file and a seed."""

import functools
import importlib.util
import json
import os
import sys

import numpy as np

PERFBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "perfbench")


@functools.lru_cache(maxsize=None)
def _generator(traffic: str, seed: int):
    name = "perfbench_traffic"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(PERFBENCH, "benchlib", "traffic.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module  # dataclasses look their module up while the file runs
        spec.loader.exec_module(module)
    with open(os.path.join(PERFBENCH, "traffic", f"{traffic}.json")) as f:
        return sys.modules[name].Generator(json.load(f), seed)


def traffic_audio(traffic: str, minutes: float, seed: int = 2404000001) -> np.ndarray:
    """A ``minutes``-long file of ``traffic`` ("longform-dense" |
    "sparse-speech") as float32 samples in [-1, 1], as a WAV of it decodes."""
    return _generator(traffic, seed).make(minutes, 0).audio

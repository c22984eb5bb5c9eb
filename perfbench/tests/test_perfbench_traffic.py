"""The traffic generator: the same seed gives the same files and words, the
length schedule is the traffic file's whatever the seed, and the reference
VAD cuts each file into the chunks the generator planned."""

import numpy as np
import pytest

from benchlib import spec
from benchlib.traffic import Generator
from reference import vad

TRAFFIC = ["longform-dense", "sparse-speech"]


def traffic(name):
    return spec.load_cell({"longform-dense": "large-v2-int8.longform-dense",
                           "sparse-speech": "large-v2-int8.sparse-speech"}[name]).traffic


@pytest.mark.parametrize("name", TRAFFIC)
def test_same_seed_same_files(name):
    t = traffic(name)
    a, b, c = Generator(t, 5), Generator(t, 5), Generator(t, 6)
    assert np.array_equal(a.file(0).pcm, b.file(0).pcm)
    assert not np.array_equal(a.file(0).pcm, c.file(0).pcm)
    assert a.transcript(0, 1, 27.5) == b.transcript(0, 1, 27.5) != c.transcript(0, 1, 27.5)


@pytest.mark.parametrize("name", TRAFFIC)
def test_length_schedule_is_fixed(name):
    t = traffic(name)
    for seed in (0, 2**31 + 11, -3):
        g = Generator(t, seed)
        assert g.cycle == [float(m) for m in t["file_minutes"]]
        lengths = [g.make(m, i).seconds for i, m in enumerate([1.5, 2.0] if name == "longform-dense" else [10.0])]
        groups = [len(g.make(m, i).groups) for i, m in enumerate([1.5, 2.0] if name == "longform-dense" else [10.0])]
        assert lengths == ([90.0, 120.0] if name == "longform-dense" else [600.0])
        assert groups == ([3, 4] if name == "longform-dense" else [3])


@pytest.mark.parametrize("name,minutes", [("longform-dense", 2.0), ("sparse-speech", 10.0)])
@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_vad_cuts_the_planned_chunks(name, minutes, seed):
    f = Generator(traffic(name), seed).make(minutes, 0)
    cut = vad.chunks(f.audio)
    assert len(cut) == len(f.groups)
    assert all(abs(a - c) < 0.3 and abs(b - d) < 0.3 for (a, b), (c, d) in zip(cut, f.groups))
    assert all(e - s <= 30.0 for s, e in cut)


def test_transcript_words_scale_with_chunk_length():
    g = Generator(traffic("longform-dense"), 3)
    assert len(g.transcript(0, 0, 30.0).split()) == 70
    assert len(g.transcript(0, 0, 15.0).split()) == 35

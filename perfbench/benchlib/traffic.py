"""The one traffic generator: WAV files and transcripts from a seed.

A traffic file (``perfbench/traffic/<name>.json``) gives the parameters:
the cycle of file lengths (fixed, so every seed sees the same length mix),
how speech is laid out in a file, the noise floor, the words of the
transcripts and the warm-up file's length. The seed sets content only:
voices, burst placement and words.

A file is a noise floor with speech "groups" on it. A group is one planned
VAD chunk: speech-like bursts separated by short pauses, spanning
``group_s`` seconds; groups are separated by gaps of ``gap_s`` seconds
(stretched to fill the file). The number of groups depends on the file's
length alone (``group_share`` of its time over the mean group), so a file
of one length always carries the same number of chunks. A group's first
burst lasts at least ``first_burst_s[0]`` seconds, which keeps the
VAD's greedy merge from packing the start of the next group into a chunk.

A burst is a slice of a voice: harmonics of a drifting pitch inside the
speech band, under a syllabic (3-6 Hz) envelope, with a little band noise.
Voices are drawn once per seed into a small bank, and bursts are slices of
it, so a run makes its audio at memory speed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

SR = 16_000


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for (seed, stream...): any whole seed,
    negative or above 64 bits included."""
    return np.random.default_rng([seed % 2**64, *stream])


@dataclass
class SpeechFile:
    index: int  # position in the traffic's cycle (-1: the warm-up file)
    seconds: float
    pcm: np.ndarray  # int16 samples
    groups: list = field(default_factory=list)  # planned chunks: (start_s, end_s)

    @property
    def audio(self) -> np.ndarray:
        """The samples as float32 in [-1, 1]: what a 16-bit WAV decodes to."""
        return self.pcm.astype(np.float32) / 32768.0


def _voice(rng: np.random.Generator, n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float32) / SR
    f0 = rng.uniform(100.0, 200.0)
    drift = 1.0 + 0.06 * np.sin(2 * np.pi * rng.uniform(0.2, 0.8) * t + rng.uniform(0, 2 * np.pi))
    phase = (2 * np.pi / SR) * np.cumsum(f0 * drift, dtype=np.float64).astype(np.float32)
    sig = np.zeros(n, np.float32)
    for k in range(2, int(3400 / f0) + 1):
        if k * f0 < 300.0:
            continue
        sig += np.float32(rng.uniform(0.4, 1.0) / np.sqrt(k)) * np.sin(k * phase + np.float32(rng.uniform(0, 2 * np.pi)))
    rate = rng.uniform(3.0, 6.0)
    syl = 2 * np.pi * rate * t + 0.8 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 2 * np.pi))
    env = (0.5 - 0.5 * np.cos(syl)) ** 1.5
    noise = rng.standard_normal(n, dtype=np.float32)
    noise = np.convolve(noise, np.ones(4, np.float32) / 4, mode="same") - np.convolve(noise, np.ones(40, np.float32) / 40, mode="same")
    sig = (sig / np.sqrt(np.mean(sig**2)) + 0.3 * noise / np.sqrt(np.mean(noise**2))) * env
    return (sig / np.sqrt(np.mean(sig**2))).astype(np.float32)


class Generator:
    """Files and transcripts of one traffic mix for one seed."""

    def __init__(self, traffic: dict, seed: int):
        self.traffic, self.seed = traffic, seed
        sp = traffic["speech"]
        rng = rng_for(seed, 0)
        # The longest burst a group can end with: a burst, a pause and a burst's floor.
        self.bank_s = float(sp["burst_s"][1] + sp["pause_s"][1] + sp["burst_s"][0]) + 1.0
        self.bank = np.stack([_voice(rng, int(self.bank_s * SR)) for _ in range(int(sp["voices"]))])

    @property
    def cycle(self) -> list:
        return [float(m) for m in self.traffic["file_minutes"]]

    def _group(self, rng, span: float) -> list:
        """Bursts of one group as (start, end) offsets filling ``span`` s."""
        sp = self.traffic["speech"]
        bmin, bmax = sp["burst_s"]
        pmin, pmax = sp["pause_s"]
        t, b, out = 0.0, rng.uniform(max(bmin, sp["first_burst_s"][0]), bmax), []
        while True:
            if t + b >= span - bmin:
                out.append((t, span))
                return out
            out.append((t, t + b))
            t += b
            p = rng.uniform(pmin, pmax)
            if t + p + bmin > span:
                out[-1] = (out[-1][0], span)
                return out
            t += p
            b = rng.uniform(bmin, bmax)

    def file(self, index: int) -> SpeechFile:
        """File ``index`` of the cycle (its length is the cycle's entry), or
        the warm-up file for ``index`` -1."""
        minutes = float(self.traffic["warmup_minutes"]) if index < 0 else self.cycle[index % len(self.cycle)]
        return self.make(minutes, index)

    def make(self, minutes: float, index: int) -> SpeechFile:
        sp = self.traffic["speech"]
        rng = rng_for(self.seed, 1, index % 2**32)
        seconds = minutes * 60.0
        n = int(round(seconds * SR))
        gmin, gmax = sp["group_s"]
        n_groups = max(1, int(np.floor(seconds * sp["group_share"] / ((gmin + gmax) / 2) + 0.5)))
        spans = rng.uniform(gmin, gmax, n_groups)
        gaps = rng.uniform(sp["gap_s"][0], sp["gap_s"][1], n_groups + 1)
        # Gaps stretch (or shrink, to no less than their floor) to fill the file.
        room = seconds - (n_groups + 1) * sp["gap_s"][0]
        if room < gmin * n_groups * 0.9:
            raise ValueError(f"a {minutes} min file cannot hold {n_groups} groups and their gaps")
        if spans.sum() > room:
            spans *= room / spans.sum()
        gaps *= (seconds - spans.sum()) / gaps.sum()
        gaps = np.maximum(gaps, sp["gap_s"][0])
        gaps *= (seconds - spans.sum()) / gaps.sum()

        audio = float(self.traffic["noise_floor"]) * rng.standard_normal(n, dtype=np.float32)
        fade = int(0.015 * SR)
        ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, fade, dtype=np.float32))
        groups, t = [], float(gaps[0])
        for g, span in enumerate(spans):
            groups.append((t, t + float(span)))
            for b0, b1 in self._group(rng, float(span)):
                i0, i1 = int((t + b0) * SR), min(n, int((t + b1) * SR))
                length = i1 - i0
                voice = rng.integers(len(self.bank))
                off = rng.integers(0, self.bank.shape[1] - length + 1)
                burst = self.bank[voice, off : off + length] * np.float32(sp["level"] * rng.uniform(0.6, 1.0))
                burst[:fade] *= ramp
                burst[-fade:] *= ramp[::-1]
                audio[i0:i1] += burst
            t += float(span) + float(gaps[g + 1])
        pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
        return SpeechFile(index=index, seconds=n / SR, pcm=pcm, groups=groups)

    def transcript(self, file_index: int, chunk: int, seconds: float) -> str:
        """The words aligned to chunk ``chunk`` of file ``file_index``:
        ``words_per_30s`` words a 30 s, drawn from the traffic's word list."""
        words = self.traffic["words"]
        rng = rng_for(self.seed, 2, file_index % 2**32, chunk)
        count = max(1, int(round(self.traffic["words_per_30s"] * seconds / 30.0)))
        return " " + " ".join(words[i] for i in rng.integers(0, len(words), count))


def write_wav(path: str, pcm: np.ndarray) -> None:
    """16-bit PCM mono WAV at 16 kHz."""
    body = np.asarray(pcm, "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, SR, SR * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(body)) + body)

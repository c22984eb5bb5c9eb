"""Native (C++) host components, exposed through ctypes.

Port of ``whisperx_tpu/native/__init__.py`` with its own copy of
``audio_native.cpp`` (tests hold the two byte for byte): a WAV decoder, a
Kaiser-windowed polyphase resampler and a background ingest pool, compiled on
first use with ``g++`` into the package's ``_build/`` directory (the one the
CUDA kernels use). This is host code, not a device kernel. Pure-numpy
fallbacks in audio/io.py keep everything working when no compiler exists —
calls here return None on any failure and the caller falls back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils import telemetry

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "audio_native.cpp")
_LIB_PATH = os.path.join(os.path.dirname(_HERE), "_build", "libwhisperx_audio.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


class _DecodedAudio(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_float)),
        ("frames", ctypes.c_int64),
        ("channels", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
    ]


def _build() -> Optional[str]:
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # Build under a per-process name, then rename: processes that build at
    # once never load a half-written library.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    except Exception:
        return None


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        fresh = os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
        with telemetry.span("build.load", built=int(not fresh)):
            path = _LIB_PATH if fresh else _build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.whisperx_decode_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(_DecodedAudio)]
            lib.whisperx_decode_wav.restype = ctypes.c_int
            lib.whisperx_pool_create.argtypes = [ctypes.c_int32]
            lib.whisperx_pool_create.restype = ctypes.c_void_p
            lib.whisperx_pool_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32
            ]
            lib.whisperx_pool_submit.restype = ctypes.c_int64
            lib.whisperx_pool_wait.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.whisperx_pool_wait.restype = ctypes.c_int32
            lib.whisperx_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.whisperx_pool_destroy.restype = None
            lib.whisperx_resample_poly.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ]
            lib.whisperx_resample_poly.restype = ctypes.c_int64
            lib.whisperx_free.argtypes = [ctypes.c_void_p]
            lib.whisperx_free.restype = None
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
        return _lib


def decode_wav(path: str):
    """Decode a WAV file → ((frames, channels) float32, rate), or None."""
    lib = _get_lib()
    if lib is None:
        return None
    out = _DecodedAudio()
    rc = lib.whisperx_decode_wav(os.fspath(path).encode(), ctypes.byref(out))
    if rc != 0:
        return None
    n = out.frames * out.channels
    try:
        arr = np.ctypeslib.as_array(out.samples, shape=(n,)).copy()
    finally:
        lib.whisperx_free(out.samples)
    return arr.reshape(out.frames, out.channels), int(out.sample_rate)


def resample_poly(audio: np.ndarray, up: int, down: int) -> Optional[np.ndarray]:
    """Rational-factor polyphase resample (float32) or None on failure."""
    lib = _get_lib()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out_ptr = ctypes.POINTER(ctypes.c_float)()
    n_out = lib.whisperx_resample_poly(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(audio),
        up,
        down,
        ctypes.byref(out_ptr),
    )
    if n_out < 0:
        return None
    try:
        result = np.ctypeslib.as_array(out_ptr, shape=(n_out,)).copy()
    finally:
        lib.whisperx_free(out_ptr)
    return result


class IngestPool:
    """Background audio ingest: paths → mono float32 waveforms at target rate.

    The native equivalent of the reference's DataLoader worker processes
    (whisperx/asr.py:158-171): a C++ std::thread pool decodes, downmixes and
    Kaiser-resamples the NEXT files while the accelerator transcribes the
    current one. Construction fails with RuntimeError when the native lib is
    unavailable — callers fall back to synchronous ``load_audio``.
    """

    def __init__(self, threads: int = 2):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native audio library unavailable")
        self._lib = lib
        self._pool = lib.whisperx_pool_create(threads)
        if not self._pool:
            raise RuntimeError("ingest pool creation failed")

    def submit(self, path: str, target_rate: int = 16000) -> int:
        return int(
            self._lib.whisperx_pool_submit(
                self._pool, os.fspath(path).encode(), target_rate
            )
        )

    def get(self, job_id: int, timeout_ms: int = -1) -> Optional[np.ndarray]:
        """Blocking fetch (timeout_ms<0). Returns the waveform, or None when
        the native decode failed (caller should fall back) or the job is
        still pending after a finite timeout."""
        out = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        rc = self._lib.whisperx_pool_wait(
            self._pool, job_id, timeout_ms, ctypes.byref(out), ctypes.byref(n)
        )
        if rc != 0:
            return None
        try:
            return np.ctypeslib.as_array(out, shape=(n.value,)).copy()
        finally:
            self._lib.whisperx_free(out)

    def close(self):
        if self._pool:
            self._lib.whisperx_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def available() -> bool:
    return _get_lib() is not None

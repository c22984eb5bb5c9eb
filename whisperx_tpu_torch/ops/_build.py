"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``whisperx_tpu_torch/_build/lib<name>-<digest>.so`` for ``sm_90a``, at
first use. The digest covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
a stale library is never loaded. Sources never include PyTorch's
headers: a build takes seconds where ``torch.utils.cpp_extension.load``
takes minutes.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

from ..utils import telemetry

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, $PATH)")


def _target(name: str) -> Path:
    """The library's path; its digest covers the source, every shared
    ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> dict[str, dict]:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Returns {name: {"seconds", "log"}} for the ones
    compiled here (``log`` holds ptxas's register/shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    errors = []
    try:
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    finally:
        for proc, tmp, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    Every source also exports ``const char* error_string(int)``. The first
    load of each writes a ``build.load`` span (count ``built``: 1 where
    ``nvcc`` ran)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with telemetry.span("build.load") as span:
                span.counts["built"] = len(build([name]))
                lib = ctypes.CDLL(str(_target(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} (cudaError_t {code})")

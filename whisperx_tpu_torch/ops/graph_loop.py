"""A decode loop as one CUDA graph launch: the counterpart of ``lax.while_loop``.

:class:`DeviceLoop` takes a ``decode/search.py`` :class:`GreedyLoop` or
:class:`BeamLoop` over static buffers and captures one ``body()`` with
``torch.cuda.graph`` (after one warm-up step on a side stream, so that lazy
set-up such as cuBLAS handles, tensor maps and shared-memory limits stays
out of the capture). ``csrc/graph_loop.cu`` then builds a graph whose
conditional WHILE node repeats that captured step while the loop's ``cont``
flag holds, testing the flag on the card before the first step and after
each one, as ``lax.while_loop`` tests its ``cond``. :meth:`DeviceLoop.launch`
enqueues the whole loop on torch's current stream and returns: nothing is
read back to the host.

Needs a CUDA runtime and CUDA driver of 12.4 or later (conditional WHILE nodes)
and a torch whose ``CUDAGraph`` keeps its captured graph (``keep_graph=True``
and ``raw_cuda_graph()``); anything less raises with the versions found.
There is no CPU path: on the CPU the host loop (``decode/search.py:
run_host_loop``) drives the same body.

Launch counts: each kernel wrapper counts its calls in Python, and a replay
makes none. A capture (its warm-up step included) leaves those counters as
they were and records how many launches of each kernel one step holds
(``body_launches``); the WHILE body's last kernel adds one to the loop's
device step counter (``DeviceLoop.steps``) each step. :func:`kernel_launches`
multiplies the two when it is read, so that a launch enqueues no counting
work.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import time
import weakref

import torch

from ..utils import telemetry
from . import _build, cross_attn, flash_attn, int8_mm, mel, self_attn_decode

MIN_CUDA = 12040  # conditional WHILE nodes: CUDA 12.4

# The kernel wrappers' launch counters, by kernel name.
COUNTERS = {"int8_matmul": int8_mm, "cross_attention_decode": cross_attn, "flash_self_attention": flash_attn, "log_mel": mel,
            "self_attn_decode": self_attn_decode}

# Loop-graph launches since the last reset_counts() (chip_smoke.py zeroes and reads it).
launches = 0
# The live loops, and (body_launches, steps) of those closed since the last
# reset_counts(): what kernel_launches() sums.
_live: "weakref.WeakSet[DeviceLoop]" = weakref.WeakSet()
_closed: list = []


def reset_counts() -> None:
    """Zero :data:`launches` and every loop's step counter."""
    global launches
    launches = 0
    _closed.clear()
    with torch.inference_mode():  # a loop made under inference mode has an inference tensor as its counter
        for loop in _live:
            loop.steps.zero_()


def kernel_launches() -> dict:
    """Launches of each kernel inside loop graphs since the last
    :func:`reset_counts`: (launches in a captured step) x (steps run), summed
    over the loops. Reads the card: it waits for the loops."""
    totals: dict = {}
    for body, steps in [(loop.body_launches, loop.steps) for loop in _live] + _closed:
        n = int(steps)
        for name, per_step in body.items():
            totals[name] = totals.get(name, 0) + per_step * n
    return totals


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("graph_loop")
    lib.graph_loop_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.graph_loop_versions.restype = ctypes.c_int
    lib.graph_loop_create.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_void_p)]
    lib.graph_loop_create.restype = ctypes.c_int
    lib.graph_loop_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.graph_loop_launch.restype = ctypes.c_int
    lib.graph_loop_destroy.argtypes = [ctypes.c_void_p]
    lib.graph_loop_destroy.restype = ctypes.c_int
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.graph_loop_versions(ctypes.byref(runtime), ctypes.byref(driver)), "cudaDriverGetVersion")
    if runtime.value < MIN_CUDA or driver.value < MIN_CUDA:
        raise RuntimeError(
            f"the device decode loop needs CUDA 12.4 or later (a conditional WHILE node): found runtime "
            f"{runtime.value // 1000}.{runtime.value % 1000 // 10}, CUDA driver {driver.value // 1000}.{driver.value % 1000 // 10}"
        )
    return lib


def _counts() -> dict:
    return {name: mod.launches for name, mod in COUNTERS.items()}


class DeviceLoop:
    """``loop`` (a search loop over static CUDA buffers) captured and built
    into a WHILE-node graph, instantiated once. The loop's state after
    construction is that of its warm-up step: call ``loop.start(...)``
    before each :meth:`launch`.

    Kept for reporting: ``body_launches`` (kernel name → launches in one
    step), ``steps`` (a 0-d int64 on the card: steps run since the last
    :func:`reset_counts`), ``capture_ms`` (warm-up + capture),
    ``instantiate_ms`` (the WHILE graph's build and instantiation) and
    ``pool_bytes`` (the captured step's private memory pool); the last three
    are also the counts of the ``decode.capture`` span the build writes."""

    def __init__(self, loop):
        dev = loop.cont.device
        if dev.type != "cuda":
            raise ValueError(f"DeviceLoop runs on a CUDA device, not {dev}: the host loop drives the CPU")
        with telemetry.span("decode.capture") as span:
            self._build(loop, dev)
            span.counts.update(capture_ms=self.capture_ms, instantiate_ms=self.instantiate_ms, pool_bytes=self.pool_bytes)
        _live.add(self)

    def _build(self, loop, dev) -> None:
        lib = _lib()
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError as e:
            raise RuntimeError(f"torch {torch.__version__}: CUDAGraph(keep_graph=True) is missing ({e})") from e
        self.loop = loop
        self.steps = torch.zeros((), dtype=torch.long, device=dev)
        before = _counts()
        with torch.cuda.device(dev):
            t0 = time.perf_counter()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                loop.body()
            torch.cuda.current_stream().wait_stream(side)
            warm = _counts()
            # torch.cuda.graph releases the cached blocks on entry; release
            # them first, so that what the capture reserves is its own pool.
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            with torch.cuda.graph(graph):
                loop.body()
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            self.body_launches = {name: n - warm[name] for name, n in _counts().items()}
            for name, mod in COUNTERS.items():  # set-up, not launches of the path
                mod.launches = before[name]
            t1 = time.perf_counter()
            exec_ = ctypes.c_void_p()
            code = lib.graph_loop_create(
                ctypes.c_void_p(graph.raw_cuda_graph()), loop.cont.data_ptr(), self.steps.data_ptr(), ctypes.byref(exec_)
            )
            _build.check(lib, code, "graph_loop_create (a WHILE node around the captured step)")
            t2 = time.perf_counter()
        self.capture_ms, self.instantiate_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        self._graph, self._exec, self._lib = graph, exec_, lib

    def launch(self) -> telemetry.Span:
        """Enqueue the whole loop on torch's current stream. Returns its
        ``decode.loop`` device span: events recorded on that stream just
        before and just after the launch (the steps it runs are the loop's
        ``step`` counter, read back with the batch's result), counting
        ``cross_attn_per_step``, the captured step's launches of
        ``cross_attention_decode`` (0 on the einsum route),
        ``int8_mm_per_step``, its launches of ``int8_matmul`` (0 where the
        step's projections have bf16 weights), and ``self_attn_per_step``,
        its launches of ``self_attn_decode`` (one a decoder layer where the
        kernel's route holds, else 0)."""
        global launches
        dev = self.loop.cont.device
        body = self.body_launches
        span = telemetry.begin("decode.loop", device=dev, cross_attn_per_step=body["cross_attention_decode"],
                               int8_mm_per_step=body["int8_matmul"], self_attn_per_step=body["self_attn_decode"])
        with torch.cuda.device(dev):
            code = self._lib.graph_loop_launch(self._exec, torch.cuda.current_stream(dev).cuda_stream)
        telemetry.end(span)
        _build.check(self._lib, code, "graph_loop_launch")
        launches += 1
        return span

    def __del__(self):
        # Dropped with its model: wait for a launch still in flight, then
        # release the graph and keep its counts.
        try:
            if self._exec is not None:
                torch.cuda.current_stream(self.loop.cont.device).synchronize()
            self.close()
        except Exception:
            pass  # interpreter shutdown: the CUDA runtime may be gone

    def close(self) -> None:
        """Destroy the instantiated graph and release the captured step's
        pool (an enqueued launch still runs to its end)."""
        if self._exec is not None:
            _build.check(self._lib, self._lib.graph_loop_destroy(self._exec), "graph_loop_destroy")
            self._exec = None
            self._graph.reset()
            _live.discard(self)
            _closed.append((self.body_launches, self.steps))

"""PyTorch/CUDA port of ``whisperx_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``audio/``, ``io/``,
``models/``, ``decode/``, ``align/``, ``ops/``, ``utils/``) so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``, ``flax`` or ``whisperx_tpu``;
framework-free modules are carried as copies.

Every Pallas kernel of the JAX package is a hand-written CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` on first use
(``ops/_build.py``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

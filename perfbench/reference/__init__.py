"""The plain reference that decides ``correct``: plain PyTorch and numpy in
float32 (TF32 off), importing neither JAX nor anything of the program."""

import contextlib

import torch


@contextlib.contextmanager
def precision():
    """Full fp32 matmuls and convolutions for the block's duration (TF32
    off on CUDA), then the settings as they were."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

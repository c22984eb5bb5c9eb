"""Fine-tuning step for Whisper (teacher-forced cross-entropy, AdamW).

Port of ``whisperx_tpu/train.py``: the same loss, the same teacher forcing
and optax.adamw's update, as an in-place PyTorch step on the model's device
(the card unless the model was built with ``device="cpu"``). The model must
be a float one made trainable (``Whisper.trainable()``); its parameters are
the fp32 masters and ``Whisper(dtype=...)`` the compute type. At bf16
compute on the card the encoder's attention takes its gradient through the
backward kernels of ``csrc/flash_attn_bwd.cu`` (``ops/flash_attn.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .models.whisper import Whisper


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean token NLL over positions where mask=1 (fp32 log-softmax; the
    denominator is at least 1)."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, targets[..., None].long())[..., 0]
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_optimizer(params, lr: float = 1e-5, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults: b1 0.9, b2
    0.999, eps 1e-8 outside the square root (optax's eps_root 0), and decay
    on every parameter (optax's ``mask=None``).

    The two updates are the same function. optax adds the decay to the
    Adam direction and scales both by the rate: p ← p - lr (adam + wd p),
    with adam = m̂ / (√v̂ + eps). torch decouples them: first p ← p (1 - lr
    wd), then p ← p - lr adam. The Adam direction does not depend on p, so
    both give p - lr wd p - lr adam; only fp32 rounding differs. Both take
    the bias corrections the same way: torch's step lr / (1 - b1^t) over
    √v / √(1 - b2^t) + eps is lr m̂ / (√v̂ + eps).
    """
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def make_train_step(
    model: Whisper, optimizer: torch.optim.Optimizer, *, timings: Optional[dict] = None
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns ``train_step(mel, tokens, loss_mask) -> loss``.

    Teacher forcing: the model reads ``tokens[:, :-1]`` and predicts
    ``tokens[:, 1:]`` under ``loss_mask[:, 1:]``. Inputs move to the model's
    device; the parameters and the optimizer's state update in place there.
    The loss comes back as a 0-d fp32 tensor on that device (no host sync).

    ``timings``, when given, is a dict into whose "forward", "backward" and
    "optimizer" lists each step appends its ms (the step then synchronizes
    the card after each phase, which costs a little time).
    """
    device = model.device

    def mark(name: Optional[str], t0: float) -> float:
        if timings is None:
            return t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        if name is not None:
            timings.setdefault(name, []).append((t - t0) * 1e3)
        return t

    def train_step(mel: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mel = mel.to(device, non_blocking=True)
        tokens = tokens.to(device, torch.long, non_blocking=True)
        mask = mask.to(device, non_blocking=True)
        optimizer.zero_grad(set_to_none=True)
        t = mark(None, 0.0)
        logits = model(mel, tokens[:, :-1])
        loss = cross_entropy_loss(logits, tokens[:, 1:], mask[:, 1:])
        t = mark("forward", t)
        loss.backward()
        t = mark("backward", t)
        optimizer.step()
        mark("optimizer", t)
        return loss.detach()

    return train_step

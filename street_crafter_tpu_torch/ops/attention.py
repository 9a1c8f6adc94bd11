"""Attention dispatch (port of ``street_crafter_tpu/ops/attention.py``).

``multi_head_attention`` is the one entry point of every transformer block.
It applies the JAX package's rule: q and kv both at least 256 long with head
dim 64 or 128 go to ``ops.flash_attention.flash_attention`` (kernel D on a
CUDA tensor, its plain version on a CPU tensor); everything else, the short
temporal axis and the length-1 cross-attention among it, goes to
``attention_plain``. There is no fallback: on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, softmax_attention


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """[B, S, H, D] x [B, Skv, H, D] -> [B, S, H, D], f32 softmax
    (``attention_xla``). For 1 < S <= 32 and Skv <= 32 (the frame axis) the
    logits are rounded to a bf16 input's dtype before the softmax, as the
    JAX package does there."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / d ** 0.5
    if q.shape[1] <= 32 and k.shape[1] <= 32 and q.shape[1] > 1:
        logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
        if q.dtype == torch.bfloat16:
            logits = logits.to(torch.bfloat16)
        probs = torch.softmax(logits.float(), dim=-1).to(logits.dtype) \
            .to(v.dtype)
        return torch.einsum("bhts,bshd->bthd", probs.float(),
                            v.float()).to(v.dtype)
    return softmax_attention(q, k, v, scale)


def uses_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's rule for the flash kernel
    (``attention.py:66-70``, its backend test aside)."""
    return (q.shape[1] >= 256 and k.shape[1] >= 256
            and q.shape[-1] in (64, 128))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Attention over [B, S, H, D] tensors."""
    if uses_flash(q, k):
        return flash_attention(q, k, v)
    return attention_plain(q, k, v)

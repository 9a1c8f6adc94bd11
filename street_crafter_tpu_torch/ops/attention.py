"""Attention dispatch (port of ``street_crafter_tpu/ops/attention.py``).

``multi_head_attention`` is the one entry point of every transformer block.
It applies the JAX package's rule: q and kv both at least 256 long with head
dim 64 or 128 go to ``ops.flash_attention.flash_attention`` (kernel D on a
CUDA tensor, its plain version on a CPU tensor); everything else, the short
temporal axis and the length-1 cross-attention among it, goes to
``attention_plain``. There is no fallback: on a CUDA tensor the kernel
launches or the call raises. A plain site that an activation checkpoint's
``SiteStore`` keeps (the "flashx" remat policy's temporal attention) runs
as ``_KeptPlainAttention``: its recompute takes the forward's output from
the store, and its backward recomputes the softmax from q and k.
"""

from __future__ import annotations

import torch

from .flash_attention import (active_store, flash_attention, kept_site,
                              softmax_attention)


def _rounds_logits(q: torch.Tensor, k: torch.Tensor) -> bool:
    """``attention_plain`` rounds the logits to bf16 on the frame axis."""
    return (q.shape[1] <= 32 and k.shape[1] <= 32 and q.shape[1] > 1
            and q.dtype == torch.bfloat16)


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


class _KeptPlainAttention(torch.autograd.Function):
    """A plain attention site kept by the innermost ``SiteStore``: the
    forward runs ``attention_plain``, or in the checkpoint's recompute
    takes its output from the store; the backward differentiates
    ``attention_plain`` from q, k and v as autograd would (the same
    softmax, and the roundings of its bf16 casts: dp to the
    probabilities' dtype, ds to the logits')."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, = kept_site(True, lambda: (attention_plain(q, k, v),), q.shape)
        ctx.save_for_backward(q, k, v)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        scale = 1.0 / q.shape[-1] ** 0.5
        rounds = _rounds_logits(q, k)
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
        if rounds:
            s = s.to(torch.bfloat16).float()
        p = torch.softmax(s, dim=-1)
        do32 = do.float()
        dv = torch.einsum("bhts,bthd->bshd", p.to(v.dtype).float(), do32)
        dp = torch.einsum("bthd,bshd->bhts", do32, v.float())
        dp = dp.to(v.dtype).float()
        ds = (dp - (dp * p).sum(-1, keepdim=True)) * p
        if rounds:
            ds = ds.to(torch.bfloat16).float()
        ds = ds * scale
        dq = torch.einsum("bhts,bshd->bthd", ds, k.float())
        dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    store = active_store()
    if (store is not None and torch.is_grad_enabled()
            and (q.shape[1], q.shape[2] * q.shape[3]) in store.temporal):
        return _KeptPlainAttention.apply(q, k, v)
    return attention_plain(q, k, v)

"""Attention forward over long sequences: kernel D and its plain version.

Port of ``street_crafter_tpu/ops/flash_attention.py``'s forward (K4
``_flash_kernel``; the eval path ``_flash``, which writes no logsumexp).
The backward kernels K5/K6 belong to fine-tuning and are not ported here.

Two implementations of one function, o = softmax(q k^T / sqrt(D)) v over
[B, S, H, D] tensors (non-causal, f32 scores and softmax, probabilities
rounded to the value dtype before the product with v):
  * ``flash_attention_reference``: plain torch, used for CPU tensors (the
    tests) and as the oracle on the card;
  * kernel D (``csrc/flash_attention.cu``), used for CUDA tensors: bf16,
    head dim 64 or 128. It is compiled with nvcc on first use; a failed
    build or launch raises, and unsupported inputs raise.
``launches`` counts the calls of each.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import cuda_build

# calls per implementation: "flash_attention" (kernel D) and
# "flash_attention_reference" (plain)
launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launches.clear()


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float | None = None) -> torch.Tensor:
    """[B, Sq, H, D] x [B, Skv, H, D] -> [B, Sq, H, D]: f32 logits and
    softmax, probabilities cast to v's dtype, products accumulated in f32
    and rounded to v's dtype (``ops/attention.py::attention_xla``)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / d ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Kernel D's plain version: ``softmax_attention`` at 1/sqrt(D)."""
    launches["flash_attention_reference"] += 1
    return softmax_attention(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """[B, Sq, H, D] x [B, Skv, H, D] -> [B, Sq, H, D], scale 1/sqrt(D).
    CUDA tensors go through kernel D, CPU tensors through the plain
    version."""
    dev = q.device
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return flash_attention_reference(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention supports cpu and cuda tensors, "
                         f"not {dev}")
    return _flash_cuda(q, k, v)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sc_flash_forward.argtypes = [P, P, P, P, I, I, I, I, I,
                                     ctypes.c_float, P]
    lib.sc_flash_forward.restype = I
    lib.sc_flash_error_string.argtypes = [I]
    lib.sc_flash_error_string.restype = ctypes.c_char_p
    return lib


def _flash_cuda(q, k, v) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if D not in (64, 128):
        raise ValueError(f"kernel D takes head dim 64 or 128, got {D}")
    if Sq == 0 or Skv == 0:
        raise ValueError("kernel D needs non-empty sequences")
    bf16 = torch.bfloat16
    pq = cuda_build.require(q, "q", bf16)
    pk = cuda_build.require(k, "k", bf16, (B, Skv, H, D))
    pv = cuda_build.require(v, "v", bf16, (B, Skv, H, D))
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sc_flash_forward(pq, pk, pv, out.data_ptr(), B, H, Sq, Skv, D,
                               1.0 / D ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"kernel D launch failed: "
                           f"{lib.sc_flash_error_string(err).decode()} "
                           f"({err})")
    launches["flash_attention"] += 1
    return out

"""Attention over long sequences: kernels D, G and H and their plain
versions.

Port of ``street_crafter_tpu/ops/flash_attention.py``: the forward (K4
``_flash_kernel``), with the logsumexp output on the training path, and the
backward (K5 ``_bwd_dkv_kernel``, K6 ``_bwd_dq_kernel``). One function,
o = softmax(q k^T / sqrt(D)) v over [B, S, H, D] tensors (non-causal, f32
scores and softmax, probabilities rounded to the value dtype before the
product with v), and its gradient. Each piece has two implementations:
  * a plain torch version (``flash_attention_reference``,
    ``flash_attention_lse_reference``, ``flash_attention_bwd_dkv_reference``,
    ``flash_attention_bwd_dq_reference``), used for CPU tensors (the tests)
    and as the oracle on the card;
  * a kernel of ``csrc/flash_attention.cu``, used for CUDA tensors: bf16,
    head dim 64 or 128. Kernel D is the forward (with lse: the training
    forward), G computes dK and dV, H dQ. The source is compiled with nvcc
    on first use; a failed build or launch raises, and unsupported inputs
    raise.
``flash_attention`` takes the no-grad forward (no lse) unless grad is
enabled and an input requires grad; then it goes through an autograd
Function that saves q, k, v, o and lse and whose backward is G and H (the
plain backward on the CPU). ``SiteStore`` lets an activation checkpoint
keep the outputs of chosen sites for its recompute (the UNet's flash
remat policies). ``launches`` counts the calls of each implementation.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools

import torch

from . import cuda_build

# calls per implementation: "flash_attention" (kernel D, no lse),
# "flash_attention_lse" (kernel D with lse), "flash_attention_bwd_dkv"
# (kernel G), "flash_attention_bwd_dq" (kernel H), and each one's
# "*_reference" (plain)
launches: collections.Counter = collections.Counter()
# f32 elements of one chunk of plain scores (1 GiB): a [9216, 9216] score
# tile is 340 MB per (batch, head)
_CHUNK_ELEMS = 1 << 28


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


def _chunks(q: torch.Tensor, skv: int):
    """(b, head slice) pieces whose f32 scores stay under _CHUNK_ELEMS."""
    B, Sq, H, _ = q.shape
    hc = max(1, min(H, _CHUNK_ELEMS // max(1, Sq * skv)))
    for b in range(B):
        for h0 in range(0, H, hc):
            yield slice(b, b + 1), slice(h0, h0 + hc)


def _scores(q, k, scale):
    """f32 scores [b, h, Sq, Skv] of bf16 (or f32) q, k [b, S, h, D]."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's training form, plain: (o as ``softmax_attention``, lse
    [B, H, Sq] f32, the logsumexp of each query's scaled scores)."""
    launches["flash_attention_lse_reference"] += 1
    B, Sq, H, D = q.shape
    scale = 1.0 / D ** 0.5
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for bs, hs in _chunks(q, k.shape[1]):
        s = _scores(q[bs, :, hs], k[bs, :, hs], scale)
        lse[bs, hs] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o[bs, :, hs] = torch.einsum("bhqk,bkhd->bqhd", p.float(),
                                    v[bs, :, hs].float()).to(v.dtype)
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, scale):
    """p = exp(s - lse) and ds = p (dp - delta) scale, rounded to bf16
    where the TPU kernels round them (p to dO's dtype, ds to q's)."""
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    return p.to(do.dtype), ds


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's plain version: (dk, dv) [B, Skv, H, D] from q, do
    [B, Sq, H, D], k, v and the forward's lse and delta = rowsum(do * o),
    [B, H, Sq] f32, with explicit f32 scores and probabilities."""
    launches["flash_attention_bwd_dkv_reference"] += 1
    scale = 1.0 / q.shape[-1] ** 0.5
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for bs, hs in _chunks(q, k.shape[1]):
        qc, kc, vc, oc = (t[bs, :, hs] for t in (q, k, v, do))
        p, ds = _probs_and_ds(qc, kc, vc, oc, lse[bs, hs], delta[bs, hs],
                              scale)
        dv[bs, :, hs] = torch.einsum("bhqk,bqhd->bkhd", p.float(),
                                     oc.float()).to(v.dtype)
        dk[bs, :, hs] = torch.einsum("bhqk,bqhd->bkhd", ds.float(),
                                     qc.float()).to(k.dtype)
    return dk, dv


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta
                                     ) -> torch.Tensor:
    """Kernel H's plain version: dq [B, Sq, H, D] from the same inputs."""
    launches["flash_attention_bwd_dq_reference"] += 1
    scale = 1.0 / q.shape[-1] ** 0.5
    dq = torch.empty_like(q)
    for bs, hs in _chunks(q, k.shape[1]):
        qc, kc, vc, oc = (t[bs, :, hs] for t in (q, k, v, do))
        _, ds = _probs_and_ds(qc, kc, vc, oc, lse[bs, hs], delta[bs, hs],
                              scale)
        dq[bs, :, hs] = torch.einsum("bhqk,bkhd->bqhd", ds.float(),
                                     kc.float()).to(q.dtype)
    return dq


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in f32, [B, Sq, H, D] -> [B, H, Sq]: one
    torch op, as the JAX package computes it outside its kernels."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()


class SiteStore:
    """The outputs of chosen attention sites, kept from a checkpointed
    block's forward for its recompute, so that the recompute does not run
    the attention there (the JAX package's ``save_only_these_names``
    policies): the flash sites (o, lse) whose query length is in
    ``seq_lens`` (``flash_out_s{S}``, ``flash_lse_s{S}``), and the plain
    attention sites whose (query length, heads x head dim) is in
    ``temporal`` (``attn_out_q{S}_c{C}``; ``ops.attention``). ``contexts()``
    gives ``torch.utils.checkpoint``'s ``context_fn`` pair: the forward
    keeps, the recompute takes back in the same order."""

    def __init__(self, seq_lens, temporal=()):
        self.seq_lens = frozenset(int(s) for s in seq_lens)
        self.temporal = frozenset((int(s), int(c)) for s, c in temporal)
        self.kept: collections.deque = collections.deque()

    @contextlib.contextmanager
    def _mode(self, mode: str):
        _active.append((self, mode))
        try:
            yield
        finally:
            _active.pop()

    def contexts(self):
        return self._mode("keep"), self._mode("reuse")


def kept_site(kept: bool, compute, shape):
    """Run one attention site under the innermost ``SiteStore``: ``kept``
    says whether the store keeps this site. In the recompute ("reuse") a
    kept site's outputs come back from the store, in order, and
    ``compute()`` does not run; otherwise ``compute()`` runs, and in the
    forward ("keep") its outputs are kept. ``shape`` is the expected
    shape of the first output."""
    store, mode = _active[-1] if _active else (None, None)
    kept = kept and store is not None
    if kept and mode == "reuse":
        if not store.kept:
            raise RuntimeError("attention site recompute found nothing kept")
        out = store.kept.popleft()
        if tuple(out[0].shape) != tuple(shape):
            raise RuntimeError(f"kept attention output {tuple(out[0].shape)}"
                               f" does not fit {tuple(shape)}")
        return out
    out = compute()
    if kept:
        store.kept.append(tuple(t.detach() for t in out))
    return out


def active_store() -> "SiteStore | None":
    """The innermost ``SiteStore`` in effect, if any."""
    return _active[-1][0] if _active else None


_active: list = []      # the innermost (SiteStore, mode) in effect


def _forward_lse(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    store = active_store()

    def compute():
        if q.device.type == "cpu":
            return flash_attention_lse_reference(q, k, v)
        return _flash_cuda(q, k, v, with_lse=True)

    kept = store is not None and q.shape[1] in store.seq_lens
    return kept_site(kept, compute, q.shape)


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel D with lse; backward: kernels G and H (on CPU
    tensors: the plain versions). Saves q, k, v, o and lse, as the JAX
    package's ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _forward_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        if q.device.type == "cpu":
            dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                       delta)
            dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta)
        else:
            dq, dk, dv = _flash_backward_cuda(q, k, v, do, lse, delta)
        return dq, dk, dv


def _check_devices(q, k, v) -> torch.device:
    dev = q.device
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention supports cpu and cuda tensors, "
                         f"not {dev}")
    return dev


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """[B, Sq, H, D] x [B, Skv, H, D] -> [B, Sq, H, D], scale 1/sqrt(D).
    CUDA tensors go through the kernels, CPU tensors through the plain
    versions. With grad enabled and an input that requires grad, the call
    is differentiable (forward with lse, backward G and H); otherwise it is
    the sampling path's forward, which writes no lse."""
    dev = _check_devices(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    if dev.type == "cpu":
        return flash_attention_reference(q, k, v)
    return _flash_cuda(q, k, v)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sc_flash_forward.argtypes = [P, P, P, P, I, I, I, I, I, F, P]
    lib.sc_flash_forward_lse.argtypes = [P, P, P, P, P, I, I, I, I, I, F, P]
    lib.sc_flash_backward_dkv.argtypes = [P, P, P, P, P, P, P, P,
                                          I, I, I, I, I, F, P]
    lib.sc_flash_backward_dq.argtypes = [P, P, P, P, P, P, P,
                                         I, I, I, I, I, F, P]
    for fn in (lib.sc_flash_forward, lib.sc_flash_forward_lse,
               lib.sc_flash_backward_dkv, lib.sc_flash_backward_dq):
        fn.restype = I
    lib.sc_flash_error_string.argtypes = [I]
    lib.sc_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.sc_flash_error_string(err).decode()} "
                           f"({err})")


def _shapes(q, k):
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if D not in (64, 128):
        raise ValueError(f"the attention kernels take head dim 64 or 128, "
                         f"got {D}")
    if Sq == 0 or Skv == 0:
        raise ValueError("the attention kernels need non-empty sequences")
    return B, Sq, H, D, Skv


def _flash_cuda(q, k, v, with_lse: bool = False):
    """Kernel D: o, or (o, lse [B, H, Sq] f32) with ``with_lse``."""
    B, Sq, H, D, Skv = _shapes(q, k)
    bf16 = torch.bfloat16
    pq = cuda_build.require(q, "q", bf16)
    pk = cuda_build.require(k, "k", bf16, (B, Skv, H, D))
    pv = cuda_build.require(v, "v", bf16, (B, Skv, H, D))
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / D ** 0.5
    if not with_lse:
        _check(lib, lib.sc_flash_forward(pq, pk, pv, out.data_ptr(), B, H,
                                         Sq, Skv, D, scale, stream),
               "kernel D")
        launches["flash_attention"] += 1
        return out
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _check(lib, lib.sc_flash_forward_lse(pq, pk, pv, out.data_ptr(),
                                         lse.data_ptr(), B, H, Sq, Skv, D,
                                         scale, stream), "kernel D (lse)")
    launches["flash_attention_lse"] += 1
    return out, lse


def _backward_args(q, k, v, do, lse, delta):
    B, Sq, H, D, Skv = _shapes(q, k)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = (cuda_build.require(q, "q", bf16),
            cuda_build.require(k, "k", bf16, (B, Skv, H, D)),
            cuda_build.require(v, "v", bf16, (B, Skv, H, D)),
            cuda_build.require(do, "do", bf16, (B, Sq, H, D)),
            cuda_build.require(lse, "lse", f32, (B, H, Sq), align=4),
            cuda_build.require(delta, "delta", f32, (B, H, Sq), align=4))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return ptrs, (B, H, Sq, Skv, D, 1.0 / D ** 0.5, stream)


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta):
    """Kernel G: (dk, dv)."""
    ptrs, dims = _backward_args(q, k, v, do, lse, delta)
    lib = _library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(lib, lib.sc_flash_backward_dkv(*ptrs, dk.data_ptr(),
                                          dv.data_ptr(), *dims), "kernel G")
    launches["flash_attention_bwd_dkv"] += 1
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta):
    """Kernel H: dq."""
    ptrs, dims = _backward_args(q, k, v, do, lse, delta)
    lib = _library()
    dq = torch.empty_like(q)
    _check(lib, lib.sc_flash_backward_dq(*ptrs, dq.data_ptr(), *dims),
           "kernel H")
    launches["flash_attention_bwd_dq"] += 1
    return dq


def _flash_backward_cuda(q, k, v, do, lse, delta):
    """Kernels G and H: (dq, dk, dv)."""
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    return _flash_bwd_dq_cuda(q, k, v, do, lse, delta), dk, dv

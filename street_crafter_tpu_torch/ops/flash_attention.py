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
  * a kernel, used for CUDA tensors, head dim 64 or 128: the bf16 forms of
    ``csrc/flash_attention.cu`` or the f32 forms of
    ``csrc/flash_attention_f32.cu`` (3xTF32 products, every operand split
    as ``tf32_split`` models), picked by q's dtype; any other dtype, or q, k, v and
    do of mixed dtypes, raises.
    Kernel D is the forward (with lse: the training forward), G computes
    dK and dV, H dQ. The sources are compiled with nvcc on first use; a
    failed build or launch raises, and unsupported inputs raise.
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
# (kernel G), "flash_attention_bwd_dq" (kernel H), each one's f32 form
# ("*_f32") and each one's "*_reference" (plain, either dtype); the TF32
# check "tf32_probe_f32" (on no path) and its "tf32_probe_reference"
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


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 product on the card reads of f32 ``x``: x with its low
    13 mantissa bits cleared (``tf32_product_probe`` checks it)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of the f32 forms of kernels D, G and H, by bit
    masks on f32 ``x``: (hi, lo) as their TF32 products read them. The kernels
    pass x's bits plus half a TF32 step as the hi operand, read as x
    rounded to TF32 (nearest, ties away from zero), and x - hi, exact in
    f32, as the lo one, read truncated: hi + lo within 2^-21 |x|. They sum
    a_lo b_hi + a_hi b_lo + a_hi b_hi in f32; the dropped a_lo b_lo is
    below 2^-22 of a b."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes torch.float32, got {x.dtype}")
    hi = tf32_read((x.view(torch.int32) + 4096).view(torch.float32))
    return hi, tf32_read(x - hi)


def tf32_product_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d = a b^T, a [64, 8] and b [8, 8] f32, by one TF32 product on the
    tensor cores (the wgmma of the f32 D, G and H, the operands' f32 bits
    passed as they are). With b the identity, d shows the value a TF32
    product reads of each f32 of a: the f32 D, G and H rely on it being
    ``tf32_read(a)``. On CPU tensors, that plain model (in float64)."""
    if a.device.type == "cpu":
        launches["tf32_probe_reference"] += 1
        return (tf32_read(a).double() @ tf32_read(b).double().T).float()
    pa = cuda_build.require(a, "a", torch.float32, (64, 8))
    pb = cuda_build.require(b, "b", torch.float32, (8, 8))
    lib = _library("_f32")
    d = torch.empty((64, 8), dtype=torch.float32, device=a.device)
    _check(lib, lib["tf32_probe"](pa, pb, d.data_ptr(),
                                  torch.cuda.current_stream(
                                      a.device).cuda_stream),
           "the TF32 probe")
    launches["tf32_probe_f32"] += 1
    return d


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


# the kernels' source and entry-name suffix by dtype: the bf16 forms
# (csrc/flash_attention.cu) and the f32 forms (csrc/flash_attention_f32.cu)
_FORMS = {torch.bfloat16: "", torch.float32: "_f32"}


def _suffix(q: torch.Tensor) -> str:
    """The kernels' suffix for q's dtype; any other dtype raises."""
    if q.dtype not in _FORMS:
        raise TypeError(f"q must be torch.bfloat16 or torch.float32, got "
                        f"{q.dtype}")
    return _FORMS[q.dtype]


@functools.lru_cache(maxsize=None)
def _library(suffix: str = "") -> dict:
    """The four entries and the error string of the bf16 (``""``) or f32
    (``"_f32"``) forms, by their names without the suffix (the f32 library
    also has ``tf32_probe``)."""
    lib = cuda_build.load("flash_attention" + suffix)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"sc_flash_forward": [P, P, P, P, I, I, I, I, I, F, P],
                "sc_flash_forward_lse": [P, P, P, P, P, I, I, I, I, I, F, P],
                "sc_flash_backward_dkv": [P, P, P, P, P, P, P, P,
                                          I, I, I, I, I, F, P],
                "sc_flash_backward_dq": [P, P, P, P, P, P, P,
                                         I, I, I, I, I, F, P]}
    fns = {}
    for name, types in argtypes.items():
        fn = getattr(lib, name + suffix)
        fn.argtypes, fn.restype = types, I
        fns[name] = fn
    if suffix == "_f32":
        fns["tf32_probe"] = lib.sc_tf32_probe_f32
        fns["tf32_probe"].argtypes, fns["tf32_probe"].restype = [P] * 4, I
    err = getattr(lib, "sc_flash_error_string" + suffix)
    err.argtypes, err.restype = [I], ctypes.c_char_p
    fns["error_string"] = err
    return fns


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib['error_string'](err).decode()} ({err})")


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
    """Kernel D (its bf16 or f32 form, by q's dtype): o, or (o, lse
    [B, H, Sq] f32) with ``with_lse``."""
    B, Sq, H, D, Skv = _shapes(q, k)
    sfx = _suffix(q)
    pq = cuda_build.require(q, "q", q.dtype)
    pk = cuda_build.require(k, "k", q.dtype, (B, Skv, H, D))
    pv = cuda_build.require(v, "v", q.dtype, (B, Skv, H, D))
    lib = _library(sfx)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / D ** 0.5
    if not with_lse:
        _check(lib, lib["sc_flash_forward"](pq, pk, pv, out.data_ptr(), B, H,
                                            Sq, Skv, D, scale, stream),
               "kernel D" + sfx)
        launches["flash_attention" + sfx] += 1
        return out
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _check(lib, lib["sc_flash_forward_lse"](pq, pk, pv, out.data_ptr(),
                                            lse.data_ptr(), B, H, Sq, Skv, D,
                                            scale, stream),
           "kernel D (lse)" + sfx)
    launches["flash_attention_lse" + sfx] += 1
    return out, lse


def _backward_args(q, k, v, do, lse, delta):
    """(entry suffix, pointers, dims) of a backward launch: q, k, v and do
    all bf16 or all f32, lse and delta f32."""
    B, Sq, H, D, Skv = _shapes(q, k)
    sfx = _suffix(q)
    f32 = torch.float32
    ptrs = (cuda_build.require(q, "q", q.dtype),
            cuda_build.require(k, "k", q.dtype, (B, Skv, H, D)),
            cuda_build.require(v, "v", q.dtype, (B, Skv, H, D)),
            cuda_build.require(do, "do", q.dtype, (B, Sq, H, D)),
            cuda_build.require(lse, "lse", f32, (B, H, Sq), align=4),
            cuda_build.require(delta, "delta", f32, (B, H, Sq), align=4))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return sfx, ptrs, (B, H, Sq, Skv, D, 1.0 / D ** 0.5, stream)


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta):
    """Kernel G (bf16 or f32 by q's dtype): (dk, dv)."""
    sfx, ptrs, dims = _backward_args(q, k, v, do, lse, delta)
    lib = _library(sfx)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(lib, lib["sc_flash_backward_dkv"](*ptrs, dk.data_ptr(),
                                             dv.data_ptr(), *dims),
           "kernel G" + sfx)
    launches["flash_attention_bwd_dkv" + sfx] += 1
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta):
    """Kernel H (bf16 or f32 by q's dtype): dq."""
    sfx, ptrs, dims = _backward_args(q, k, v, do, lse, delta)
    lib = _library(sfx)
    dq = torch.empty_like(q)
    _check(lib, lib["sc_flash_backward_dq"](*ptrs, dq.data_ptr(), *dims),
           "kernel H" + sfx)
    launches["flash_attention_bwd_dq" + sfx] += 1
    return dq


def _flash_backward_cuda(q, k, v, do, lse, delta):
    """Kernels G and H: (dq, dk, dv)."""
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    return _flash_bwd_dq_cuda(q, k, v, do, lse, delta), dk, dv

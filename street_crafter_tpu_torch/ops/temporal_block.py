"""The temporal transformer stage: kernels E and F and their plain versions.

Port of ``street_crafter_tpu/ops/temporal_block.py``:
  * ``temporal_block_fused`` (K7 ``_kernel``): the whole temporal stage of
    ``SpatialVideoTransformer`` at C <= 384, from the stage input h to the
    AlphaBlender output, in the (b t) s c layout;
  * ``temporal_attention_fused`` (K8 ``_attn_kernel``): its attention
    sub-stage only, h + out(attn_T(LN(h))) + bias, at 384 < C <= 1280.
Each has two implementations of one function:
  * ``*_reference``: plain torch with the TPU kernel's rounding to bf16
    (after each LayerNorm, the QKV product, the probabilities, the attention
    and projection outputs, each residual and bias add, and the output),
    products of bf16 values accumulated in f32; used for CPU tensors (the
    tests) and as the oracle on the card;
  * kernels E and F (``csrc/temporal_block.cu``), used for CUDA tensors;
    compiled with nvcc on first use; a failed build or launch raises.
Weights are in torch Linear layout ([out, in]); ``wqkv`` is to_q, to_k and
to_v stacked on the output axis ([3C, C]). Everything is cast to bf16, as
the TPU kernel casts its weights. ``launches`` counts the calls of each.

The GEMM that kernels E and F chain is exposed one launch at a time
(``temporal_gemm``, by epilogue), with a plain version of its own, so that
each product can be timed and held against plain torch alone; the main
paths call only the fused entries above.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import cuda_build

LN_EPS = 1e-6
# calls per implementation: "temporal_block_fused" (kernel E),
# "temporal_attention_fused" (kernel F), the GEMM piece "temporal_gemm",
# and each one's "*_reference" (plain)
launches: collections.Counter = collections.Counter()

# the GEMM epilogues of csrc/temporal_block.cu (enum Epi)
EPILOGUES = {"store": 0, "geglu": 1, "resid": 2, "resid_bias": 3,
             "resid_blend": 4, "add_f32": 5}
# the operands each epilogue reads besides a, w and the bias
_EPILOGUE_NEEDS = {"store": (), "geglu": (), "resid": ("resid",),
                   "resid_bias": ("resid", "rowbias"),
                   "resid_blend": ("resid", "blend_h"),
                   "add_f32": ("resid", "rowbias")}
_BLOCK_WEIGHTS = ("norm_in_s", "norm_in_b", "ffin_w1", "ffin_b1", "ffin_w2",
                  "ffin_b2", "norm1_s", "norm1_b", "wqkv", "wout", "bout",
                  "norm3_s", "norm3_b", "ff_w1", "ff_b1", "ff_w2", "ff_b2")


def reset_launch_counts() -> None:
    launches.clear()


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _ln(x, s, b, eps=LN_EPS):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * s.float() + b.float()).to(torch.bfloat16)


def _mm(a, w, b=None):
    """bf16 a [.., K] times bf16 w [N, K]^T, f32 result (+ f32 bias)."""
    out = a.float() @ w.float().t()
    return out if b is None else out + b.float()


def _geglu(x, w1, b1, w2, b2):
    u = _mm(x, w1, b1)
    a, g = u.chunk(2, dim=-1)
    y = (a * torch.nn.functional.gelu(g, approximate="tanh")).to(
        torch.bfloat16)
    return _mm(y, w2, b2)


def _attn_T(qkv, B, T, S, heads):
    """Attention over the T frames of each (b, s) in the (b t) s c layout;
    qkv [B*T, S, 3C] bf16 -> [B*T, S, C] bf16."""
    C = qkv.shape[-1] // 3
    dh = C // heads
    q, k, v = (t.reshape(B, T, S, heads, dh).float()
               for t in qkv.split(C, dim=-1))
    s = torch.einsum("btshd,bushd->bshtu", q, k) * (1.0 / dh ** 0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pr = (p / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    o = torch.einsum("bshtu,bushd->btshd", pr.float(), v)
    return o.reshape(B * T, S, C).to(torch.bfloat16)


def _bf16(*ts):
    return [t.to(torch.bfloat16) for t in ts]


def temporal_block_fused_reference(h, emb, alpha, bias, norm_in_s, norm_in_b,
                                   ffin_w1, ffin_b1, ffin_w2, ffin_b2,
                                   norm1_s, norm1_b, wqkv, wout, bout,
                                   norm3_s, norm3_b, ff_w1, ff_b1, ff_w2,
                                   ff_b2, *, num_frames: int, heads: int,
                                   dim_head: int) -> torch.Tensor:
    """Plain version of kernel E: h [B*T, S, C], emb [B*T, C], alpha (f32
    scalar), bias [B, C] -> [B*T, S, C] bf16."""
    launches["temporal_block_fused_reference"] += 1
    BT, S, C = h.shape
    T = num_frames
    B = BT // T
    bf = torch.bfloat16
    (h, emb, bias, norm_in_s, norm_in_b, ffin_w1, ffin_b1, ffin_w2, ffin_b2,
     norm1_s, norm1_b, wqkv, wout, bout, norm3_s, norm3_b, ff_w1, ff_b1,
     ff_w2, ff_b2) = _bf16(h, emb, bias, norm_in_s, norm_in_b, ffin_w1,
                           ffin_b1, ffin_w2, ffin_b2, norm1_s, norm1_b, wqkv,
                           wout, bout, norm3_s, norm3_b, ff_w1, ff_b1, ff_w2,
                           ff_b2)
    x = (h.float() + emb.float()[:, None]).to(bf)
    x = (x.float() + _geglu(_ln(x, norm_in_s, norm_in_b), ffin_w1, ffin_b1,
                            ffin_w2, ffin_b2).to(bf).float()).to(bf)
    qkv = _mm(_ln(x, norm1_s, norm1_b), wqkv).to(bf)
    att = _attn_T(qkv, B, T, S, heads)
    x = (x.float() + _mm(att, wout, bout).to(bf).float()).to(bf)
    x = (x.float() + bias.float().repeat_interleave(T, 0)[:, None]).to(bf)
    x = (x.float() + _geglu(_ln(x, norm3_s, norm3_b), ff_w1, ff_b1, ff_w2,
                            ff_b2).to(bf).float()).to(bf)
    a = float(alpha)
    return (a * h.float() + (1.0 - a) * x.float()).to(bf)


def temporal_attention_fused_reference(h, bias, norm1_s, norm1_b, wqkv, wout,
                                       bout, *, num_frames: int, heads: int,
                                       dim_head: int) -> torch.Tensor:
    """Plain version of kernel F: h [B*T, S, C], bias [B, C] ->
    h + out(attn_T(LN(h))) + bias, rounded once to bf16."""
    launches["temporal_attention_fused_reference"] += 1
    BT, S, C = h.shape
    T = num_frames
    B = BT // T
    h, bias, norm1_s, norm1_b, wqkv, wout, bout = _bf16(
        h, bias, norm1_s, norm1_b, wqkv, wout, bout)
    qkv = _mm(_ln(h, norm1_s, norm1_b), wqkv).to(torch.bfloat16)
    att = _attn_T(qkv, B, T, S, heads)
    res = h.float() + _mm(att, wout, bout) \
        + bias.float().repeat_interleave(T, 0)[:, None]
    return res.to(torch.bfloat16)


def temporal_gemm_reference(epi: str, a, w, bias=None, resid=None,
                            rowbias=None, rows_per_batch: int = 1,
                            blend_h=None, alpha: float = 0.0):
    """Plain version of one GEMM piece: a [M, K] times w [N, K]^T ([2N, K]
    for "geglu") in f32 from bf16 values, then the epilogue ``epi`` with
    kernel E's and F's bf16 roundings (``EPILOGUES``); rowbias [M /
    rows_per_batch, N] is added per block of rows_per_batch rows."""
    launches["temporal_gemm_reference"] += 1
    bf = torch.bfloat16
    a, w = _bf16(a, w)
    acc = _mm(a, w, None if bias is None else bias.to(bf))
    if epi == "store":
        return acc.to(bf)
    if epi == "geglu":
        u, g = acc.chunk(2, dim=-1)
        return (u * torch.nn.functional.gelu(g, approximate="tanh")).to(bf)
    r = resid.to(bf).float()
    if epi == "add_f32":
        rb = rowbias.to(bf).float().repeat_interleave(rows_per_batch, 0)
        return (r + acc + rb).to(bf)
    x = r + acc.to(bf).float()
    if epi == "resid":
        return x.to(bf)
    x = x.to(bf).float()
    if epi == "resid_bias":
        rb = rowbias.to(bf).float().repeat_interleave(rows_per_batch, 0)
        return (x + rb).to(bf)
    if epi == "resid_blend":
        return (alpha * blend_h.to(bf).float() + (1.0 - alpha) * x).to(bf)
    raise ValueError(f"unknown epilogue {epi!r}")


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _check_shapes(h, num_frames, heads, dim_head):
    BT, S, C = h.shape
    if BT % num_frames or heads * dim_head != C:
        raise ValueError(f"h {tuple(h.shape)} does not fit {num_frames} "
                         f"frames x {heads} heads x {dim_head}")


def _on_cuda(h, *others) -> bool:
    dev = h.device
    for t in others:
        if torch.is_tensor(t) and t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"temporal kernels support cpu and cuda tensors, "
                         f"not {dev}")
    return True


def temporal_block_fused(h, emb, alpha, bias, norm_in_s, norm_in_b, ffin_w1,
                         ffin_b1, ffin_w2, ffin_b2, norm1_s, norm1_b, wqkv,
                         wout, bout, norm3_s, norm3_b, ff_w1, ff_b1, ff_w2,
                         ff_b2, *, num_frames: int, heads: int,
                         dim_head: int) -> torch.Tensor:
    """The whole temporal stage (K7). CUDA tensors go through kernel E, CPU
    tensors through the plain version."""
    _check_shapes(h, num_frames, heads, dim_head)
    args = (h, emb, alpha, bias, norm_in_s, norm_in_b, ffin_w1, ffin_b1,
            ffin_w2, ffin_b2, norm1_s, norm1_b, wqkv, wout, bout, norm3_s,
            norm3_b, ff_w1, ff_b1, ff_w2, ff_b2)
    kw = dict(num_frames=num_frames, heads=heads, dim_head=dim_head)
    if not _on_cuda(h, *args[1:]):
        return temporal_block_fused_reference(*args, **kw)
    return _block_cuda(*args, **kw)


def temporal_attention_fused(h, bias, norm1_s, norm1_b, wqkv, wout, bout, *,
                             num_frames: int, heads: int,
                             dim_head: int) -> torch.Tensor:
    """Temporal attention sub-stage (K8). CUDA tensors go through kernel F,
    CPU tensors through the plain version."""
    _check_shapes(h, num_frames, heads, dim_head)
    args = (h, bias, norm1_s, norm1_b, wqkv, wout, bout)
    kw = dict(num_frames=num_frames, heads=heads, dim_head=dim_head)
    if not _on_cuda(*args):
        return temporal_attention_fused_reference(*args, **kw)
    return _attention_cuda(*args, **kw)


def temporal_gemm(epi: str, a, w, bias=None, resid=None, rowbias=None,
                  rows_per_batch: int = 1, blend_h=None,
                  alpha: float = 0.0) -> torch.Tensor:
    """One GEMM piece of kernels E and F, out [M, N] (see the reference).
    CUDA tensors go through ``gemm_kernel<epi>``, CPU tensors through the
    plain version."""
    if epi not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epi!r}")
    M, K = a.shape
    needs = _EPILOGUE_NEEDS[epi]
    given = dict(resid=resid, rowbias=rowbias, blend_h=blend_h)
    for name in needs:
        if given[name] is None:
            raise ValueError(f"epilogue {epi!r} needs {name}")
    if "rowbias" in needs and (rows_per_batch <= 0 or M % rows_per_batch):
        raise ValueError(f"rows_per_batch {rows_per_batch} does not divide "
                         f"M = {M}")
    if not _on_cuda(a, w, bias, resid, rowbias, blend_h):
        return temporal_gemm_reference(epi, a, w, bias, resid, rowbias,
                                       rows_per_batch, blend_h, alpha)
    N = w.shape[0] // 2 if epi == "geglu" else w.shape[0]
    if K % 8:
        raise ValueError(f"the GEMM takes K % 8 == 0, got {K}")
    if epi == "geglu" and w.shape[0] % 2:
        raise ValueError(f"a GEGLU weight stacks a and gate rows, got "
                         f"{w.shape[0]} rows")
    bf16 = torch.bfloat16
    pa = cuda_build.require(a, "a", bf16)
    pw = cuda_build.require(w, "w", bf16, (w.shape[0], K))

    def opt(t, name, shape):
        return 0 if t is None else cuda_build.require(t, name, bf16, shape)
    pb = opt(bias, "bias", (2 * N if epi == "geglu" else N,))
    pr = opt(resid, "resid", (M, N)) if "resid" in needs else 0
    prb = (opt(rowbias, "rowbias", (M // rows_per_batch, N))
           if "rowbias" in needs else 0)
    ph = opt(blend_h, "blend_h", (M, N)) if "blend_h" in needs else 0
    out = torch.empty((M, N), dtype=bf16, device=a.device)
    lib = _library()
    _raise(lib, lib.sc_temporal_gemm(
        EPILOGUES[epi], pa, pw, out.data_ptr(), M, N, K, pb, pr, prb,
        rows_per_batch, ph, float(alpha), _stream(a)), f"the {epi} GEMM")
    launches["temporal_gemm"] += 1
    return out


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("temporal_block")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sc_temporal_block.argtypes = [P, P, P, F] + [P] * 17 + [P] * 5 \
        + [I] * 5 + [P]
    lib.sc_temporal_block.restype = I
    lib.sc_temporal_attention.argtypes = [P] * 11 + [I] * 5 + [P]
    lib.sc_temporal_attention.restype = I
    L = ctypes.c_longlong
    lib.sc_temporal_gemm.argtypes = [I, P, P, P, L, I, I, P, P, P, L, P, F,
                                     P]
    lib.sc_temporal_gemm.restype = I
    lib.sc_temporal_error_string.argtypes = [I]
    lib.sc_temporal_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_shape(T, C, dim_head):
    if T > 32:
        raise ValueError(f"kernels E/F take at most 32 frames, got {T}")
    if dim_head not in (16, 32, 64):
        raise ValueError(f"kernels E/F take head dim 16, 32 or 64, got "
                         f"{dim_head}")
    if C % 8 or C > 2048:
        raise ValueError(f"kernels E/F take C % 8 == 0 and C <= 2048, got "
                         f"{C}")


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.sc_temporal_error_string(err).decode()} "
                           f"({err})")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _weights(names, values, shapes):
    bf16 = torch.bfloat16
    return [cuda_build.require(w, n, bf16, s)
            for n, w, s in zip(names, values, shapes)]


def _block_cuda(h, emb, alpha, bias, *weights, num_frames, heads, dim_head):
    BT, S, C = h.shape
    T = num_frames
    B = BT // T
    _check_kernel_shape(T, C, dim_head)
    bf16 = torch.bfloat16
    inner = 4 * C
    shapes = [(C,), (C,), (2 * inner, C), (2 * inner,), (C, inner), (C,),
              (C,), (C,), (3 * C, C), (C, C), (C,), (C,), (C,),
              (2 * inner, C), (2 * inner,), (C, inner), (C,)]
    ptrs = _weights(_BLOCK_WEIGHTS, weights, shapes)
    ph = cuda_build.require(h, "h", bf16, (BT, S, C))
    pe = cuda_build.require(emb, "emb", bf16, (BT, C))
    pb = cuda_build.require(bias, "bias", bf16, (B, C))
    M = BT * S
    out = torch.empty_like(h)
    x = torch.empty((M, C), dtype=bf16, device=h.device)
    y = torch.empty_like(x)
    att = torch.empty_like(x)
    big = torch.empty((M, inner), dtype=bf16, device=h.device)
    lib = _library()
    err = lib.sc_temporal_block(
        ph, pe, pb, float(alpha), *ptrs, out.data_ptr(), x.data_ptr(),
        y.data_ptr(), big.data_ptr(), att.data_ptr(), B, T, S, C, heads,
        _stream(h))
    _raise(lib, err, "kernel E")
    launches["temporal_block_fused"] += 1
    return out


def _attention_cuda(h, bias, norm1_s, norm1_b, wqkv, wout, bout, *,
                    num_frames, heads, dim_head):
    BT, S, C = h.shape
    T = num_frames
    B = BT // T
    _check_kernel_shape(T, C, dim_head)
    bf16 = torch.bfloat16
    ptrs = _weights(("norm1_s", "norm1_b", "wqkv", "wout", "bout"),
                    (norm1_s, norm1_b, wqkv, wout, bout),
                    [(C,), (C,), (3 * C, C), (C, C), (C,)])
    ph = cuda_build.require(h, "h", bf16, (BT, S, C))
    pb = cuda_build.require(bias, "bias", bf16, (B, C))
    M = BT * S
    out = torch.empty_like(h)
    y = torch.empty((M, C), dtype=bf16, device=h.device)
    att = torch.empty_like(y)
    qkv = torch.empty((M, 3 * C), dtype=bf16, device=h.device)
    lib = _library()
    err = lib.sc_temporal_attention(
        ph, pb, *ptrs, out.data_ptr(), y.data_ptr(), qkv.data_ptr(),
        att.data_ptr(), B, T, S, C, heads, _stream(h))
    _raise(lib, err, "kernel F")
    launches["temporal_attention_fused"] += 1
    return out


def stage_cost(B: int, T: int, S: int, C: int, full: bool) -> dict:
    """Bytes each kernel must move (inputs read once, output written once,
    bf16) and its operations, from the shapes: kernel E (``full``) or F.
    Products count 2 per multiply-add; attention over T per (b, s, head)."""
    M = B * T * S
    att = 4 * M * T * C                       # QK^T and PV
    qkv_out = 2 * M * C * 3 * C + 2 * M * C * C
    if not full:
        w = 3 * C * C + C * C + 3 * C
        return {"bytes": 2 * (2 * M * C + B * C + w),
                "flops": qkv_out + att}
    ff = 2 * (2 * M * C * 8 * C + 2 * M * 4 * C * C)   # ff_in and ff
    w = 2 * (8 * C * C + 8 * C + 4 * C * C + C) + 3 * C * C + C * C + 7 * C
    return {"bytes": 2 * (2 * M * C + B * T * C + B * C + w),
            "flops": ff + qkv_out + att}

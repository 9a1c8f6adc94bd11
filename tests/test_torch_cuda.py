"""The CUDA kernels of street_crafter_tpu_torch (raster A-C, attention D,
its backward G and H,
temporal stage E and F) against their plain torch versions on a CUDA
device. Marked ``cuda``; each test skips when no CUDA
device is present. On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: the worklist must be equal; compositing agrees to atol 2e-4 on
rgb and alpha (both decide the 1/255 and 1e-4 thresholds on identically
rounded values; only the colour sums run in another order); the backward
(kernel C) agrees per field to 1e-4 (GRAD_RTOL below) of the field's
largest gradient, of its norm and, in the median over splats, of each
splat's own gradient.
"""

import numpy as np
import pytest
import torch

from street_crafter_tpu_torch.ops import gs_raster as G

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def splat_args(device, n, W, H, seed, wide):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(1.0, 8.0, n)
    k = int(wide * n)
    sigma[:k] = rng.uniform(30.0, 100.0, k)
    ca = 1.0 / sigma ** 2
    cc = 1.0 / (0.7 * sigma) ** 2
    depth = rng.uniform(1.0, 80.0, n)
    valid = rng.random(n) > 0.05

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(u=t(rng.uniform(-40, W + 40, n)),
                v=t(rng.uniform(-40, H + 40, n)), conic_a=t(ca),
                conic_b=t(0.3 * np.sqrt(ca * cc) * rng.uniform(-1, 1, n)),
                conic_c=t(cc),
                colors=t(np.concatenate([rng.random((n, 3)),
                                         depth[:, None]], 1)),
                opacities=t(rng.uniform(0.02, 1.0, n)), depths=t(depth),
                valid=t(valid, torch.bool),
                radii=t(np.ceil(3 * sigma) * valid), width=W, height=H)


@pytest.mark.parametrize("seed,wide", [(0, 0.0), (1, 0.1)])
def test_kernels_match_plain_versions(cuda, seed, wide):
    args = splat_args(cuda, 20_000, 200, 136, seed, wide)
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    G.reset_launch_counts()
    wl = G.tile_worklist(**geo)
    ref = G.tile_worklist_reference(**geo)
    assert wl.n_pairs == ref.n_pairs > 0
    for name in ("tile_ids", "gauss_ids", "ranges"):
        assert torch.equal(getattr(wl, name), getattr(ref, name)), name
    col, alpha = G.composite(wl, **comp)
    col_ref, alpha_ref = G.composite_reference(wl, **comp)
    torch.testing.assert_close(col[..., :3], col_ref[..., :3], atol=2e-4,
                               rtol=0)
    torch.testing.assert_close(alpha, alpha_ref, atol=2e-4, rtol=0)
    assert G.launches["tile_worklist"] == G.launches["composite"] == 1


def test_rasterize_pixels_launches_kernels(cuda):
    args = splat_args(cuda, 2_000, 64, 48, 2, 0.05)
    G.reset_launch_counts()
    out = G.rasterize_pixels(**args)
    assert out.colors.is_cuda and out.colors.shape == (48, 64, 4)
    assert dict(G.launches) == {"tile_worklist": 1, "composite": 1}
    empty = {k: (v[:0] if isinstance(v, torch.Tensor) else v)
             for k, v in args.items()}
    out = G.rasterize_pixels(**empty)
    assert out.n_pairs == 0 and float(out.alpha.abs().max()) == 0.0


FIELDS = {"u": G.GRAD_U, "v": G.GRAD_V, "conic_a": G.GRAD_A,
          "conic_b": G.GRAD_B, "conic_c": G.GRAD_C,
          "opacity": G.GRAD_OPACITY, "absgrad": G.GRAD_ABS,
          "colors": slice(G.GRAD_COLORS, None)}
# kernel C against the plain backward, per field: kernel C rebuilds T by
# division where the plain version scans with cumprod, sums the suffix in
# another order, and adds per-splat sums with atomics in a run-dependent
# order, so the two differ by f32 rounding only
GRAD_RTOL = 1e-4


@pytest.mark.parametrize("seed,wide", [(0, 0.0), (1, 0.1)])
def test_kernel_c_matches_plain_backward(cuda, seed, wide):
    args = splat_args(cuda, 20_000, 200, 136, seed, wide)
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    wl = G.tile_worklist(**geo)
    out, alpha, final_T, last = G.composite(wl, **comp, train=True)
    ref = G.composite_reference(wl, **comp, train=True)
    assert torch.equal(last, ref[3])       # the same stop decisions
    torch.testing.assert_close(final_T, ref[2], atol=1e-6, rtol=0)
    rng = np.random.default_rng(seed + 10)
    gcol = torch.tensor(rng.normal(size=out.shape), dtype=torch.float32,
                        device=cuda)
    gal = torch.tensor(rng.normal(size=alpha.shape), dtype=torch.float32,
                       device=cuda)
    G.reset_launch_counts()
    got = G.composite_backward(wl, **comp, final_T=final_T, last=last,
                               grad_colors=gcol, grad_alpha=gal)
    want = G.composite_backward_reference(wl, **comp, grad_colors=gcol,
                                          grad_alpha=gal)
    assert G.launches["composite_backward"] == 1
    for name, col in FIELDS.items():
        g, w = got[:, col].flatten(), want[:, col].flatten()
        diff, mag = (g - w).abs(), w.abs()
        scale = float(mag.max())
        assert scale > 0 and float(diff.max()) <= GRAD_RTOL * scale, name
        # the norm, and the median splat: small splats count too
        assert float(torch.linalg.vector_norm(g - w)) <= \
            GRAD_RTOL * float(torch.linalg.vector_norm(w)), name
        nz = mag > 0
        assert float((diff[nz] / mag[nz]).median()) <= GRAD_RTOL, name


def test_rasterize_pixels_backward_launches_kernel_c(cuda):
    args = splat_args(cuda, 2_000, 64, 48, 4, 0.05)
    leaves = {k: args[k].clone().requires_grad_(True)
              for k in ("u", "v", "conic_a", "conic_b", "conic_c", "colors",
                        "opacities")}
    sink = torch.zeros((2_000, 2), device=cuda, requires_grad=True)
    G.reset_launch_counts()
    out = G.rasterize_pixels(**dict(args, **leaves), absgrad_sink=sink)
    (out.colors.sum() + out.alpha.sum()).backward()
    assert dict(G.launches) == {"tile_worklist": 1, "composite": 1,
                                "composite_backward": 1}
    for t in list(leaves.values()) + [sink]:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    assert float(sink.grad.max()) > 0


def test_kernel_wrappers_check_inputs(cuda):
    args = splat_args(cuda, 100, 32, 32, 3, 0.0)
    strided = dict(args, u=torch.stack([args["u"], args["u"]], 1)[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        G.rasterize_pixels(**strided)
    with pytest.raises(TypeError, match="float32"):
        G.rasterize_pixels(**dict(args, v=args["v"].double()))
    with pytest.raises(ValueError, match="tensors on"):
        G.rasterize_pixels(**dict(args, u=args["u"].cpu()))


# ---------------------------------------------------------------------------
# kernels D (attention forward), E and F (the temporal stage) against their
# plain versions, in bf16. Tolerances: the largest error within 2e-2 of the
# largest |output| and the median within 2e-3: the kernels sum in another
# order, kernel D rounds its probabilities against a running max, and the
# plain versions round the same bf16 intermediates, so a bf16 ulp or two of
# drift is expected where an intermediate rounds the other way.

from street_crafter_tpu_torch.ops import flash_attention as FA  # noqa: E402
from street_crafter_tpu_torch.ops import temporal_block as TB  # noqa: E402

BF16_MAX, BF16_MED = 2e-2, 2e-3


def bf16_errors(got, want):
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    return float(d.max()) / scale, float(d.median()) / scale


@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 100, 75, 3, 64),
                                          (1, 300, 257, 2, 128),
                                          (2, 576, 576, 4, 64)])
def test_kernel_d_matches_plain_attention(cuda, b, sq, skv, h, d):
    g = torch.Generator(device=cuda).manual_seed(sq)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=cuda)
               .to(torch.bfloat16) for n in (sq, skv, skv))
    FA.reset_launch_counts()
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == 1
    worst, med = bf16_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


def _stage_inputs(cuda, B, T, S, C, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * sc).to(
            torch.bfloat16)
    inner = 4 * C
    w = dict(norm_in_s=1 + r(C, sc=.1), norm_in_b=r(C, sc=.1),
             ffin_w1=r(2 * inner, C, sc=C ** -.5), ffin_b1=r(2 * inner, sc=.1),
             ffin_w2=r(C, inner, sc=inner ** -.5), ffin_b2=r(C, sc=.1),
             norm1_s=1 + r(C, sc=.1), norm1_b=r(C, sc=.1),
             wqkv=r(3 * C, C, sc=C ** -.5), wout=r(C, C, sc=C ** -.5),
             bout=r(C, sc=.1), norm3_s=1 + r(C, sc=.1), norm3_b=r(C, sc=.1),
             ff_w1=r(2 * inner, C, sc=C ** -.5), ff_b1=r(2 * inner, sc=.1),
             ff_w2=r(C, inner, sc=inner ** -.5), ff_b2=r(C, sc=.1))
    return r(B * T, S, C), r(B * T, C, sc=.3), r(B, C, sc=.2), w


@pytest.mark.parametrize("B,T,S,C,heads", [(2, 25, 48, 64, 1),
                                           (1, 5, 100, 320, 5),
                                           (2, 3, 16, 32, 2)])
def test_kernel_e_matches_plain_stage(cuda, B, T, S, C, heads):
    h, emb, bias, w = _stage_inputs(cuda, B, T, S, C, C + S)
    args = (h, emb, 0.3, bias, *[w[k] for k in TB._BLOCK_WEIGHTS])
    kw = dict(num_frames=T, heads=heads, dim_head=C // heads)
    TB.reset_launch_counts()
    got = TB.temporal_block_fused(*args, **kw)
    want = TB.temporal_block_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert TB.launches["temporal_block_fused"] == 1
    worst, med = bf16_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


@pytest.mark.parametrize("B,T,S,C,heads", [(2, 25, 75, 640, 10),
                                           (1, 25, 16, 1280, 20)])
def test_kernel_f_matches_plain_attention_stage(cuda, B, T, S, C, heads):
    h, _, bias, w = _stage_inputs(cuda, B, T, S, C, C + S)
    names = ("norm1_s", "norm1_b", "wqkv", "wout", "bout")
    args = (h, bias, *[w[k] for k in names])
    kw = dict(num_frames=T, heads=heads, dim_head=C // heads)
    TB.reset_launch_counts()
    got = TB.temporal_attention_fused(*args, **kw)
    want = TB.temporal_attention_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert TB.launches["temporal_attention_fused"] == 1
    worst, med = bf16_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


def test_vdm_kernel_wrappers_check_inputs(cuda):
    q = torch.zeros((1, 300, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(*(torch.zeros((1, 300, 2, 80), device=cuda,
                                         dtype=torch.bfloat16),) * 3)
    h, _, bias, w = _stage_inputs(cuda, 1, 40, 16, 64, 0)
    with pytest.raises(ValueError, match="32 frames"):
        TB.temporal_attention_fused(h, bias, w["norm1_s"], w["norm1_b"],
                                    w["wqkv"], w["wout"], w["bout"],
                                    num_frames=40, heads=1, dim_head=64)


def _attn_case(cuda, b, sq, skv, h, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=cuda)
               .to(torch.bfloat16) for n in (sq, skv, skv))
    do = torch.randn((b, sq, h, d), generator=g, device=cuda).to(
        torch.bfloat16)
    return q, k, v, do


@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 100, 75, 3, 64),
                                          (1, 75, 100, 2, 128),
                                          (1, 300, 257, 2, 64),
                                          (2, 576, 576, 4, 64)])
def test_attention_training_kernels_match_plain(cuda, b, sq, skv, h, d):
    """Kernel D with lse, G and H against their plain versions on the same
    inputs (seeded cotangents), in bf16."""
    q, k, v, do = _attn_case(cuda, b, sq, skv, h, d, sq + skv)
    FA.reset_launch_counts()
    o, lse = FA._flash_cuda(q, k, v, with_lse=True)
    o_ref, lse_ref = FA.flash_attention_lse_reference(q, k, v)
    delta = FA.attention_delta(o_ref, do)
    dq, dk, dv = FA._flash_backward_cuda(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = FA.flash_attention_bwd_dkv_reference(q, k, v, do,
                                                          lse_ref, delta)
    dq_ref = FA.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention_lse"] == 1
    assert FA.launches["flash_attention_bwd_dkv"] == 1
    assert FA.launches["flash_attention_bwd_dq"] == 1
    for got, want in ((o, o_ref), (lse, lse_ref), (dq, dq_ref),
                      (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        worst, med = bf16_errors(got, want)
        assert worst <= BF16_MAX and med <= BF16_MED


def test_attention_function_backward_launches_g_and_h(cuda):
    q, k, v, do = _attn_case(cuda, 1, 300, 260, 2, 64, 5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    FA.reset_launch_counts()
    out = FA.flash_attention(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    assert dict(FA.launches) == {"flash_attention_lse": 1,
                                 "flash_attention_bwd_dkv": 1,
                                 "flash_attention_bwd_dq": 1}
    for t in (q, k, v):
        assert t.grad is not None and t.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(t.grad).all())
    with torch.no_grad():
        FA.flash_attention(q, k, v)
    assert FA.launches["flash_attention"] == 1


def test_attention_training_wrappers_check_inputs(cuda):
    q, k, v, do = _attn_case(cuda, 1, 300, 300, 2, 64, 6)
    with pytest.raises(ValueError, match="tensors on"):
        FA.flash_attention(q, k.cpu(), v)
    wide = torch.zeros((1, 300, 2, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        FA._flash_cuda(wide[..., ::2], k, v, with_lse=True)
    lse = torch.zeros((1, 2, 300), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        FA._flash_backward_cuda(q, k, v, do.float(), lse, lse)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((1, 300, 2, 32), device=cuda, dtype=torch.bfloat16)
        FA._flash_backward_cuda(x, x, x, x, lse, lse)

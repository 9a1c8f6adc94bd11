"""Plain versions of kernels D, E and F and the resizes of the port's
sampling path (street_crafter_tpu_torch) against the JAX package on the
CPU, on the same numpy inputs. The JAX Pallas kernels (K4 flash forward,
K7 / K8 temporal stage) run in interpret mode, as the JAX package's own
tests run them.

Tolerances, with their reasons:
  * f32 attention (K4 vs ``flash_attention_reference``, and the short-axis
    ``attention_plain`` vs ``attention_xla``): 1e-5 of the largest |output|:
    the same softmax summed in another order (online vs two-pass);
  * bf16 attention: 2e-2 of the largest |output|, median 2e-3: the
    probabilities are rounded to bf16 against a running max (kernel) or the
    final max (plain version);
  * K7 / K8 (bf16 throughout): largest error 2e-2 of the largest |output|
    and median 2e-3. The port's plain versions round to bf16 where the TPU
    kernel's code does; XLA on the CPU runs the interpreted kernel with
    excess precision (``xla_allow_excess_precision``, on by default) and
    skips some of those roundings, so the two differ by a few bf16 ulps
    where a residual add is rounded twice (measured: 7.5e-3 and 7.5e-4 at
    C = 64; with excess precision off, 1.5e-3 of elements differ by one ulp);
  * the bicubic CLIP resize: 1e-5 absolute on [0, 1] images (the same
    weights; f32 products summed in another order);
  * the Lanczos resize: exact (Pillow's integer arithmetic), so within the
    1/255 the port promises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.ops import flash_attention as JFA
from street_crafter_tpu.ops import temporal_block as JTB
from street_crafter_tpu.ops.attention import attention_xla
from street_crafter_tpu_torch.ops import attention as PA
from street_crafter_tpu_torch.ops import flash_attention as PFA
from street_crafter_tpu_torch.ops import temporal_block as PTB

F32_RTOL = 1e-5
BF16_MAX, BF16_MED = 2e-2, 2e-3


@pytest.fixture
def interpret(monkeypatch):
    """Run pallas kernels interpreted on the CPU."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def rel_errors(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(largest, median) |got - want| over the largest |want|."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    scale = max(float(np.abs(want).max()), 1e-12)
    return float(d.max()) / scale, float(np.median(d)) / scale


def to_bf16_np(x: np.ndarray) -> np.ndarray:
    return torch.tensor(x).bfloat16().float().numpy()


@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 128, 128, 3, 64),
                                          (1, 100, 75, 2, 64),
                                          (1, 300, 260, 1, 128)])
def test_flash_reference_matches_k4_f32(interpret, b, sq, skv, h, d):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32)
               for n in (sq, skv, skv))
    want = np.asarray(JFA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v)))
    PFA.reset_launch_counts()
    got = PFA.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v)).numpy()
    assert dict(PFA.launches) == {"flash_attention_reference": 1}
    assert rel_errors(got, want)[0] <= F32_RTOL


def test_flash_reference_matches_k4_bf16(interpret):
    rng = np.random.default_rng(7)
    q, k, v = (to_bf16_np(rng.normal(size=(1, 300, 2, 64))) for _ in range(3))
    bf = jnp.bfloat16
    want = np.asarray(JFA.flash_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf)),
        np.float32)
    got = PFA.flash_attention(*(torch.tensor(x).bfloat16() for x in (q, k, v))
                              ).float().numpy()
    worst, med = rel_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


@pytest.mark.parametrize("sq,skv,d,dtype", [(25, 25, 64, "float32"),
                                            (25, 25, 64, "bfloat16"),
                                            (9, 1, 16, "float32"),
                                            (300, 300, 64, "float32"),
                                            (300, 300, 80, "float32")])
def test_multi_head_attention_matches_attention_xla(sq, skv, d, dtype):
    """The port's dispatch on CPU tensors against the JAX CPU path
    (attention_xla), both branches: the frame axis (<= 32) and long
    sequences (the flash gate; head dim 80 misses it)."""
    rng = np.random.default_rng(sq * d)
    q = rng.normal(size=(3, sq, 2, d)).astype(np.float32)
    k, v = (rng.normal(size=(3, skv, 2, d)).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        q, k, v = (to_bf16_np(x) for x in (q, k, v))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(attention_xla(*(jnp.asarray(x, jd) for x in (q, k, v))),
                      np.float32)
    PFA.reset_launch_counts()
    got = PA.multi_head_attention(*(torch.tensor(x).to(td)
                                    for x in (q, k, v))).float().numpy()
    assert (sum(PFA.launches.values()) == 1) == (sq >= 256 and d == 64)
    worst, med = rel_errors(got, want)
    if dtype == "float32":
        assert worst <= F32_RTOL
    else:
        assert worst <= BF16_MAX and med <= BF16_MED


def _block_weights(rng, C):
    inner = 4 * C

    def r(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)
    return dict(
        norm_in_s=1 + r(C, sc=.1), norm_in_b=r(C, sc=.1),
        ffin_w1=r(C, 2 * inner, sc=C ** -.5), ffin_b1=r(2 * inner, sc=.1),
        ffin_w2=r(inner, C, sc=inner ** -.5), ffin_b2=r(C, sc=.1),
        norm1_s=1 + r(C, sc=.1), norm1_b=r(C, sc=.1),
        wqkv=r(C, 3 * C, sc=C ** -.5), wout=r(C, C, sc=C ** -.5),
        bout=r(C, sc=.1), norm3_s=1 + r(C, sc=.1), norm3_b=r(C, sc=.1),
        ff_w1=r(C, 2 * inner, sc=C ** -.5), ff_b1=r(2 * inner, sc=.1),
        ff_w2=r(inner, C, sc=inner ** -.5), ff_b2=r(C, sc=.1))


def _torch_layout(w: dict) -> dict:
    """flax Dense [in, out] -> torch Linear [out, in]."""
    return {k: torch.tensor(v.T.copy() if v.ndim == 2 else v)
            for k, v in w.items()}


@pytest.mark.parametrize("B,T,S,C,heads", [(2, 5, 32, 64, 1),
                                           (1, 3, 16, 32, 2),
                                           (2, 25, 16, 64, 1)])
def test_temporal_block_reference_matches_k7(B, T, S, C, heads):
    rng = np.random.default_rng(B * T * S + C)
    h = rng.normal(size=(B * T, S, C)).astype(np.float32)
    emb = (0.3 * rng.normal(size=(B * T, C))).astype(np.float32)
    bias = (0.2 * rng.normal(size=(B, C))).astype(np.float32)
    W = _block_weights(rng, C)
    alpha = 0.3
    want = np.asarray(JTB.temporal_block_fused(
        jnp.asarray(h), jnp.asarray(emb), jnp.float32(alpha),
        jnp.asarray(bias), *[jnp.asarray(W[k]) for k in PTB._BLOCK_WEIGHTS],
        num_frames=T, heads=heads, dim_head=C // heads, rows_per_block=8,
        interpret=True), np.float32)
    tw = _torch_layout(W)
    PTB.reset_launch_counts()
    got = PTB.temporal_block_fused(
        torch.tensor(h), torch.tensor(emb), alpha, torch.tensor(bias),
        *[tw[k] for k in PTB._BLOCK_WEIGHTS], num_frames=T, heads=heads,
        dim_head=C // heads).float().numpy()
    assert dict(PTB.launches) == {"temporal_block_fused_reference": 1}
    worst, med = rel_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


@pytest.mark.parametrize("B,T,S,C,heads", [(1, 3, 16, 640, 10),
                                           (2, 5, 16, 64, 1)])
def test_temporal_attention_reference_matches_k8(B, T, S, C, heads):
    rng = np.random.default_rng(C + T)
    h = rng.normal(size=(B * T, S, C)).astype(np.float32)
    bias = (0.2 * rng.normal(size=(B, C))).astype(np.float32)
    W = _block_weights(rng, C)
    names = ("norm1_s", "norm1_b", "wqkv", "wout", "bout")
    want = np.asarray(JTB.temporal_attention_fused(
        jnp.asarray(h), jnp.asarray(bias), *[jnp.asarray(W[k]) for k in names],
        num_frames=T, heads=heads, dim_head=C // heads, rows_per_block=16,
        interpret=True), np.float32)
    tw = _torch_layout(W)
    PTB.reset_launch_counts()
    got = PTB.temporal_attention_fused(
        torch.tensor(h), torch.tensor(bias), *[tw[k] for k in names],
        num_frames=T, heads=heads, dim_head=C // heads).float().numpy()
    assert dict(PTB.launches) == {"temporal_attention_fused_reference": 1}
    worst, med = rel_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


def _pieces_inputs(B, T, S, C):
    rng = np.random.default_rng(B * T + S + C)
    bf = torch.bfloat16
    h = torch.tensor(rng.normal(size=(B * T, S, C)), dtype=bf)
    emb = torch.tensor(0.3 * rng.normal(size=(B * T, C)), dtype=bf)
    bias = torch.tensor(0.2 * rng.normal(size=(B, C)), dtype=bf)
    W = {k: v.to(bf) for k, v in _torch_layout(_block_weights(rng, C)).items()}
    return h, emb, bias, W


@pytest.mark.parametrize("B,T,S,C,heads", [(2, 5, 8, 64, 1),
                                           (1, 3, 16, 32, 2)])
def test_temporal_pieces_chain_to_kernel_e_plain_version(B, T, S, C, heads):
    """Kernel E's GEMM pieces (each epilogue), chained with the plain
    LayerNorm and attention over T as csrc/temporal_block.cu::
    sc_temporal_block chains them, give E's plain version bit for bit: the
    GEMMs chip_smoke.py times alone are the stage's."""
    h, emb, bias, W = _pieces_inputs(B, T, S, C)
    BT, M = B * T, B * T * S
    PTB.reset_launch_counts()
    x = (h.float() + emb.float()[:, None]).to(torch.bfloat16)
    y = PTB._ln(x, W["norm_in_s"], W["norm_in_b"])
    x = x.reshape(M, C)
    g = PTB.temporal_gemm("geglu", y.reshape(M, C), W["ffin_w1"], W["ffin_b1"])
    x = PTB.temporal_gemm("resid", g, W["ffin_w2"], W["ffin_b2"], resid=x)
    y = PTB._ln(x.reshape(BT, S, C), W["norm1_s"], W["norm1_b"])
    qkv = PTB.temporal_gemm("store", y.reshape(M, C), W["wqkv"])
    att = PTB._attn_T(qkv.reshape(BT, S, 3 * C), B, T, S, heads)
    x = PTB.temporal_gemm("resid_bias", att.reshape(M, C), W["wout"],
                          W["bout"], resid=x, rowbias=bias,
                          rows_per_batch=T * S)
    y = PTB._ln(x.reshape(BT, S, C), W["norm3_s"], W["norm3_b"])
    g = PTB.temporal_gemm("geglu", y.reshape(M, C), W["ff_w1"], W["ff_b1"])
    out = PTB.temporal_gemm("resid_blend", g, W["ff_w2"], W["ff_b2"],
                            resid=x, blend_h=h.reshape(M, C), alpha=0.3)
    want = PTB.temporal_block_fused_reference(
        h, emb, 0.3, bias, *[W[k] for k in PTB._BLOCK_WEIGHTS],
        num_frames=T, heads=heads, dim_head=C // heads)
    assert dict(PTB.launches) == {"temporal_gemm_reference": 6,
                                  "temporal_block_fused_reference": 1}
    assert torch.equal(out.reshape(BT, S, C), want)


@pytest.mark.parametrize("B,T,S,C,heads", [(1, 3, 16, 640, 10),
                                           (2, 5, 8, 64, 1)])
def test_temporal_pieces_chain_to_kernel_f_plain_version(B, T, S, C, heads):
    """Kernel F's GEMM pieces, chained with the plain LayerNorm and
    attention over T as sc_temporal_attention chains them, give F's plain
    version bit for bit."""
    h, _, bias, W = _pieces_inputs(B, T, S, C)
    BT, M = B * T, B * T * S
    y = PTB._ln(h, W["norm1_s"], W["norm1_b"])
    qkv = PTB.temporal_gemm("store", y.reshape(M, C), W["wqkv"])
    att = PTB._attn_T(qkv.reshape(BT, S, 3 * C), B, T, S, heads)
    out = PTB.temporal_gemm("add_f32", att.reshape(M, C), W["wout"],
                            W["bout"], resid=h.reshape(M, C), rowbias=bias,
                            rows_per_batch=T * S)
    want = PTB.temporal_attention_fused_reference(
        h, bias, *[W[k] for k in ("norm1_s", "norm1_b", "wqkv", "wout",
                                  "bout")],
        num_frames=T, heads=heads, dim_head=C // heads)
    assert torch.equal(out.reshape(BT, S, C), want)


def test_temporal_gemm_checks_its_epilogue_arguments():
    a = torch.zeros((6, 16), dtype=torch.bfloat16)
    w = torch.zeros((8, 16), dtype=torch.bfloat16)
    rowbias = torch.zeros((2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown epilogue"):
        PTB.temporal_gemm("gelu", a, w)
    with pytest.raises(ValueError, match="needs resid"):
        PTB.temporal_gemm("resid", a, w)
    with pytest.raises(ValueError, match="rows_per_batch 4"):
        PTB.temporal_gemm("add_f32", a, w, resid=torch.zeros((6, 8)),
                          rowbias=rowbias, rows_per_batch=4)


def test_stage_cost_counts_the_level0_work():
    """The bound's operation count at the UNet's level 0 (the CFG batch of
    2 x 25 frames at 72 x 128, C = 320): ~2.65 TFLOP for kernel E."""
    e = PTB.stage_cost(2, 25, 72 * 128, 320, full=True)
    f = PTB.stage_cost(2, 25, 48 * 48, 640, full=False)
    assert 2.6e12 < e["flops"] < 2.7e12
    assert e["bytes"] == 2 * (2 * 460800 * 320 + 50 * 320 + 2 * 320) \
        + 2 * (2 * (8 * 320 * 320 + 8 * 320 + 4 * 320 * 320 + 320)
               + 4 * 320 * 320 + 7 * 320)
    assert f["flops"] == 2 * 115200 * 640 * 4 * 640 + 4 * 115200 * 25 * 640


@pytest.mark.parametrize("shape,size", [((2, 576, 1024, 3), 224),
                                        ((1, 37, 50, 3), 64)])
def test_clip_resize_matches_jax_bicubic(shape, size):
    from street_crafter_tpu_torch.models.vdm.clip import resize_bicubic
    x = np.random.default_rng(size).random(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (shape[0], size, size, 3), "bicubic"))
    got = resize_bicubic(torch.tensor(x), size, size).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("hw,thw,crop", [((1280, 1920), (576, 1024), "bottom"),
                                         ((90, 100), (64, 96), "center"),
                                         ((80, 60), (40, 56), "bottom")])
def test_aspect_crop_resize_matches_jax(hw, thw, crop):
    from street_crafter_tpu.runner.diffusion import aspect_crop_resize as J
    from street_crafter_tpu_torch.datasets.vdm_data import aspect_crop_resize
    img = np.random.default_rng(hw[0]).random(hw + (3,)).astype(np.float32)
    img = np.clip(img * 0.5 + np.linspace(0, 0.5, hw[1])[None, :, None], 0, 1)
    want = J(img, *thw, crop=crop)
    got = aspect_crop_resize(img, *thw, crop=crop)
    assert got.shape == want.shape == thw + (3,)
    assert np.abs(got - want).max() <= 1e-7

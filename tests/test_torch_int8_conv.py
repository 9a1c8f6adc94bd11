"""The W8A8 int8 eval path of the port (``UNetConfig.quant_convs``,
``ops/int8_conv.py``: kernel Q's plain version on the CPU) against the JAX
package's ``Int8Conv`` (``models/vdm/layers.py``) and its quantized UNet.

- Q's plain version against ``Int8Conv`` (flax ``apply``) for strides 1
  and 2, odd sizes and up to 300 input channels: the int32 products are
  equal (JAX's by Int8Conv's own steps, checked to reproduce its output
  bit for bit) and the outputs within 1 float32 ulp (measured: bit-equal).
- The plain version's products are exact where float32 is not: 2,560
  channels of +-127 levels sum to 3.7e8 > 2^24.
- ``ResBlock`` (with and without its skip convolution), ``Downsample``,
  ``Upsample`` and ``VideoResBlock`` with ``quant_convs`` against JAX's,
  with converted parameters; the tiny UNet with ``quant_convs`` against
  JAX's (``tests/test_unet.py::test_quant_convs_close_to_f32``'s
  perturbed parameters) and, as JAX's own outer check, within 2% of JAX's
  float32 UNet.
- The tiny UNet on ``{frames: 2}`` gloo ranks (the activation's maximum
  all-reduced over the frames group) against one process.
- A call that would record gradients raises (eval only).

Tolerance. Upstream of each quantized convolution the two frameworks
compute in float32 in another order, so an activation that lands within
round-off of a rounding boundary may take the neighbouring int8 level in
one of them. One such flip is not small: a level is max|x| / 127, and
one flipped level moved the tiny UNet's output by up to 2.6e-2 of its
largest value (measured over 78 single flips, one in each of the 26
convolutions' inputs at three places, with what it moves downstream): as
much as quantization itself (1.3e-2 against float32). A flip moves every
activation after it by ~1e-3, so later convolutions flip many levels in
turn: the flips counted are those of the first convolution with any. The
rate is what keeps the comparison tight: 2 of 704,512 levels flipped
between JAX and the port (2.8e-6; the tiny UNet's 26 convolutions, 0 of
409,600 with upstream drift at most 1.6e-6 of an input's largest value;
the five blocks below at seeds 1-8, 2 of 294,912, both in the ResBlock
with a skip convolution, each moving its output by 8.6e-4 and 7.0e-4;
the frames test below, 1 in the 16th convolution, moving the output by
7.0e-3). Without a flip the outputs agree to 7.2e-7. So every comparison
counts the flips (each side's convolution inputs, quantized with its own
scale), allows at most 1 + MAX_FLIP_SHARE of the levels to flip (a test
sees ~1e-2 flips on average), and allows F32_RTOL (the float32 UNet's
parity tolerance, ``tests/test_torch_vdm_modules.py``) plus FLIP_EFFECT
for each flip.
"""

import contextlib
import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.vdm import layers as JL
from street_crafter_tpu.models.vdm.unet import UNetConfig as JUNetConfig
from street_crafter_tpu.models.vdm.unet import VideoUNet as JVideoUNet
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm import layers as PL
from street_crafter_tpu_torch.models.vdm.unet import UNetConfig, VideoUNet
from street_crafter_tpu_torch.ops import int8_conv as Q
from street_crafter_tpu_torch.parallel.mesh import run_ranks
from tests import torch_sp_ranks as SR
from tests.torch_port_helpers import random_params

F32_RTOL = 1e-5
FLIP_EFFECT = 3e-2        # one flipped level: measured up to 2.6e-2
MAX_FLIP_SHARE = 1e-5     # measured 2.8e-6
JAX_F32_RTOL = 0.02       # JAX's own int8 UNet against its float32 one


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t) -> np.ndarray:
    return np.moveaxis(np.asarray(t), 1, -1)


@contextlib.contextmanager
def jax_conv_inputs():
    """The input of every ``Int8Conv`` the JAX model applies, in order
    (NHWC numpy; through a debug callback, as the UNet's blocks run under
    remat)."""
    seen = []

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, JL.Int8Conv) and \
                context.method_name == "__call__":
            jax.debug.callback(lambda a: seen.append(np.asarray(
                a, np.float32)), args[0])
        return next_fun(*args, **kwargs)
    with nn.intercept_methods(intercept):
        yield seen


@contextlib.contextmanager
def port_conv_inputs():
    """The input of every quantized convolution the port runs, in order
    (NHWC numpy)."""
    seen = []
    products = Q.int8_products_reference

    def record(x, *args, **kw):
        seen.append(nhwc(x.detach().numpy()))
        return products(x, *args, **kw)
    Q.int8_products_reference = record
    try:
        yield seen
    finally:
        Q.int8_products_reference = products


def levels(x: np.ndarray) -> np.ndarray:
    """The int8 levels of an activation under its own per-tensor scale."""
    t = torch.tensor(x)
    return Q.quantize_reference(t, Q.activation_scale_reference(t)).numpy()


def count_flips(want: list, got: list) -> tuple[int, int]:
    """(levels that differ, levels) over the convolutions' inputs, up to
    the first convolution where any level differs: one flip moves every
    activation after it by ~1e-3, and the flips that follow are its
    consequences, which FLIP_EFFECT (measured with them) covers."""
    assert len(got) == len(want) > 0
    total = 0
    for a, b in zip(want, got):
        assert a.shape == b.shape
        total += a.size
        flips = int((levels(a) != levels(b)).sum())
        if flips:
            return flips, total
    return 0, total


def assert_within(got, want, flips: int, total: int) -> None:
    assert flips <= 1 + MAX_FLIP_SHARE * total, (flips, total)
    err = rel_err(got, want)
    print(f"{flips} of {total} levels flipped; largest error {err:.3g}")
    assert err <= F32_RTOL + FLIP_EFFECT * flips, (err, flips)


# ------------------------------------------------------- Q's plain version

def jax_products(x, kernel, stride):
    """Int8Conv's own steps in JAX (``layers.py:104-121``): the int32
    products, wscale and xscale."""
    k32 = jnp.asarray(kernel, jnp.float32)
    wscale = jnp.maximum(jnp.max(jnp.abs(k32), axis=(0, 1, 2)), 1e-12) / 127.0
    wq = jnp.clip(jnp.round(k32 / wscale), -127, 127).astype(jnp.int8)
    x32 = jnp.asarray(x, jnp.float32)
    xscale = jnp.maximum(jnp.max(jnp.abs(x32)), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(x32 / xscale), -127, 127).astype(jnp.int8)
    o = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return o, wscale, xscale


@pytest.mark.parametrize("N,H,W,C,O,stride", [
    (2, 7, 9, 5, 6, 1), (3, 9, 11, 37, 13, 2), (2, 8, 8, 300, 40, 1),
    (1, 10, 6, 130, 17, 2), (2, 5, 5, 64, 64, 2)])
def test_plain_version_matches_jax_int8conv(N, H, W, C, O, stride):
    rng = np.random.default_rng(N * 1000 + C)
    x = (3.0 * rng.normal(size=(N, H, W, C))).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, C, O)) / np.sqrt(9 * C)).astype(
        np.float32)
    bias = (0.1 * rng.normal(size=(O,))).astype(np.float32)
    mod = JL.Int8Conv(O, (3, 3), strides=(stride, stride),
                      padding=((1, 1), (1, 1)), out_dtype=jnp.float32)
    want = np.asarray(mod.apply({"params": {"kernel": kernel,
                                            "bias": bias}}, x))
    o, wscale, xscale = jax_products(x, kernel, stride)
    np.testing.assert_array_equal(
        np.asarray(o.astype(jnp.float32) * (wscale * xscale) + bias), want)
    w = torch.tensor(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))
    prod, xs, ws = Q.int8_products_reference(nchw(x), w, stride)
    np.testing.assert_array_equal(nhwc(prod.numpy()), np.asarray(o))
    assert float(xs[0]) == float(xscale)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(wscale))
    Q.reset_launch_counts()
    with torch.no_grad():
        got = nhwc(Q.int8_conv2d(nchw(x), w, torch.tensor(bias),
                                 stride).numpy())
    assert dict(Q.launches) == {"int8_conv_reference": 1}
    assert got.shape == want.shape == (N, -(-H // stride), -(-W // stride),
                                       O)
    ulps = np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))
    assert ulps.max() <= 1.0


def test_plain_products_exact_past_float32():
    """2,560 channels of levels +-127 with +-127 weights: sums up to
    127^2 x 9 x 2560 = 371,612,160 > 2^24, against int64 numpy."""
    rng = np.random.default_rng(0)
    C, O = 2560, 3
    xq = np.full((1, C, 3, 3), 127, np.int8)
    xq[0, rng.random(C) < 0.01] = -127
    wq = np.where(rng.random((O, C, 3, 3)) < 0.5, 127, -127).astype(np.int8)
    wq[0] = 127
    got = Q.int_products_reference(torch.tensor(xq), torch.tensor(wq),
                                   1).numpy()
    xp = np.pad(xq[0].astype(np.int64), ((0, 0), (1, 1), (1, 1)))
    want = np.zeros((O, 3, 3), np.int64)
    for i in range(3):
        for j in range(3):
            want[:, i, j] = np.einsum("ocyx,cyx->o", wq.astype(np.int64),
                                      xp[:, i:i + 3, j:j + 3])
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got[0], want)


def test_grad_enabled_call_raises():
    x = torch.randn(1, 8, 4, 4, requires_grad=True)
    w = torch.randn(8, 8, 3, 3)
    with pytest.raises(RuntimeError, match="eval-only"):
        Q.int8_conv2d(x, w, None)
    conv = torch.nn.Conv2d(8, 8, 3, padding=1)
    with pytest.raises(RuntimeError, match="eval-only"):
        PL.quant_conv(x.detach(), conv)          # the weight requires grad
    with torch.no_grad():
        assert PL.quant_conv(x, conv).shape == (1, 8, 4, 4)


# ---------------------------------------------------------------- blocks

B, T, E = 1, 2, 16


def _block_case(kind: str, seed: int):
    """(JAX module, its apply arguments, port module, its call)."""
    rng = np.random.default_rng(seed)
    C, O = (32, 64) if kind == "resblock_skip" else (32, 32)
    x = rng.normal(size=(B * T, 8, 6, C)).astype(np.float32)
    emb = rng.normal(size=(B * T, E)).astype(np.float32)
    if kind in ("resblock", "resblock_skip"):
        jmod = JL.ResBlock(out_channels=O, dims=2, quant_convs=True)
        pmod = PL.ResBlock(C, E, O, dims=2, quant_convs=True)
        args, pcall = (x, emb), (lambda m: m(nchw(x), torch.tensor(emb)))
        wrap, names = (lambda p: {"m": {"spatial": p}}), \
            PCV._resblock_map("m", "m")
    elif kind == "video_resblock":
        jmod = JL.VideoResBlock(out_channels=O, quant_convs=True)
        pmod = PL.VideoResBlock(C, E, O, quant_convs=True)
        args = (x, emb, T)
        pcall = (lambda m: m(nchw(x), torch.tensor(emb), T))
        wrap, names = (lambda p: {"m": p}), PCV._resblock_map("m", "m")
    else:
        jmod = {"downsample": JL.Downsample, "upsample": JL.Upsample}[kind](
            quant_convs=True)
        pmod = {"downsample": PL.Downsample, "upsample": PL.Upsample}[kind](
            C, quant_convs=True)
        args, pcall = (x,), (lambda m: m(nchw(x)))
        conv = "op" if kind == "downsample" else "conv"
        wrap, names = (lambda p: {"m": p}), {f"m.{conv}": "m/conv"}
    params = random_params(jax.eval_shape(
        lambda k: jmod.init(k, *args), jax.random.PRNGKey(seed)), seed)
    sd = PCV.state_dict_from_jax(wrap(params["params"]), names)
    pmod.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jmod, params, args, pmod, pcall


@pytest.mark.parametrize("kind", ["resblock", "resblock_skip", "downsample",
                                  "upsample", "video_resblock"])
def test_blocks_match_jax(kind):
    jmod, params, args, pmod, pcall = _block_case(kind, 7)
    with jax_conv_inputs() as jin:
        want = np.asarray(jmod.apply(params, *args))
    Q.reset_launch_counts()
    with port_conv_inputs() as pin, torch.no_grad():
        got = nhwc(pcall(pmod).numpy())
    n_convs = 2 if "resblock" in kind else 1
    assert dict(Q.launches) == {"int8_conv_reference": n_convs}
    assert len(jin) == n_convs
    assert got.shape == want.shape
    assert_within(got, want, *count_flips(jin, pin))


# ------------------------------------------------------------------ UNet

UT, UH, UW = 2, 16, 16


@pytest.fixture(scope="module")
def unets():
    """tests/test_unet.py's tiny UNet (f32 and quant_convs) with its
    perturbed parameters (init + 0.02 N(0, 1)), and guidance inputs, in
    JAX; the parameters converted for the port."""
    cfg = JUNetConfig.tiny()
    k = jax.random.PRNGKey(0)
    x = jax.random.normal(k, (UT, UH, UW, cfg.in_channels))
    t = jnp.full((UT,), 0.25)
    ctx = jax.random.normal(jax.random.PRNGKey(1), (UT, 1, cfg.context_dim))
    y = jax.random.normal(jax.random.PRNGKey(2), (UT, cfg.adm_in_channels))
    g = jax.random.normal(jax.random.PRNGKey(5),
                          (UT, UH, UW, cfg.in_channels // 2))
    params = JVideoUNet(cfg).init(jax.random.PRNGKey(3), x, t, ctx, y,
                                  num_frames=UT, guidance_input=g)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(4), len(leaves))
    params = jax.tree_util.tree_unflatten(
        treedef, [l + 0.02 * jax.random.normal(kk, l.shape, l.dtype)
                  for l, kk in zip(leaves, keys)])
    sd = PCV.state_dict_from_jax(params, PCV.unet_name_map(UNetConfig.tiny()),
                                 "unet")
    with torch.device("meta"):
        shapes = VideoUNet(UNetConfig.tiny()).state_dict()
    sd = {n: v.reshape(shapes[n].shape).numpy() for n, v in sd.items()}
    return dict(cfg=cfg, params=params, inputs=(x, t, ctx, y, g), sd=sd)


def _port_unet(sd: dict, quant: bool) -> VideoUNet:
    m = VideoUNet(dataclasses.replace(UNetConfig.tiny(), quant_convs=quant))
    m.load_state_dict({n: torch.tensor(v) for n, v in sd.items()})
    return m.requires_grad_(False)


def test_unet_matches_jax(unets):
    x, t, ctx, y, g = unets["inputs"]
    jq = JVideoUNet(dataclasses.replace(unets["cfg"], quant_convs=True))
    call = functools.partial(jq.apply, unets["params"], x, t, ctx, y,
                             num_frames=UT, guidance_input=g)
    with jax_conv_inputs() as jin:
        want = np.asarray(call())
    want_f32 = np.asarray(JVideoUNet(unets["cfg"]).apply(
        unets["params"], x, t, ctx, y, num_frames=UT, guidance_input=g))
    Q.reset_launch_counts()
    with port_conv_inputs() as pin, torch.no_grad():
        got = _port_unet(unets["sd"], True)(
            *(torch.tensor(np.asarray(a)) for a in (x, t, ctx, y)),
            num_frames=UT, guidance_input=torch.tensor(np.asarray(g))
        ).numpy()
    # 2 convs in each of 12 ResBlocks, one Downsample, one Upsample
    assert dict(Q.launches) == {"int8_conv_reference": 26}
    assert got.shape == want.shape == (UT, UH, UW, 4)
    assert_within(got, want, *count_flips(jin, pin))
    assert rel_err(got, want_f32) <= JAX_F32_RTOL
    assert rel_err(got, want_f32) > 10 * F32_RTOL      # it did quantize


def _frames_inputs(rng, Tc: int) -> dict:
    """One clip of ``Tc`` frames, as ``torch_sp_ranks.quant_unet`` takes
    it."""
    ins = {"x": rng.normal(size=(Tc, UH, UW, 8)),
           "t": rng.normal(size=(Tc,)),
           "ctx": ("per_clip", rng.normal(size=(1, 1, 48))),
           "y": ("per_clip", rng.normal(size=(1, 24))),
           "cm": np.eye(Tc)[0],
           "g": rng.normal(size=(Tc, UH, UW, 4)),
           "gs": np.ones(Tc)}
    return {k: (v[0], v[1].astype(np.float32)) if isinstance(v, tuple)
            else v.astype(np.float32) for k, v in ins.items()}


def test_unet_on_frames_ranks_matches_one_process(unets, tmp_path):
    """{frames: 2}: each rank quantizes its frames with the clip's scale
    (the maximum all-reduced over the group), so its levels are one
    process's."""
    Tc, f = 4, 2
    inputs = _frames_inputs(np.random.default_rng(11), Tc)
    one = SR.quant_unet(None, None, unets["sd"], inputs, Tc)
    ranks = run_ranks(SR.quant_unet, f, str(tmp_path), {"frames": f},
                      unets["sd"], inputs, Tc, timeout_s=240)
    assert one["launches"] == {"int8_conv_reference": 26}
    L = Tc // f
    got = np.concatenate([r["out"] for r in ranks])
    # the ranks' conv inputs, frames back in clip order
    joined = [np.concatenate([r["inputs"][i] for r in ranks])
              for i in range(len(one["inputs"]))]
    for r in ranks:
        assert r["launches"] == one["launches"]
        assert r["out"].shape == (L, UH, UW, 4)
    flips, total = count_flips([nhwc(a) for a in one["inputs"]],
                               [nhwc(a) for a in joined])
    assert_within(got, one["out"], flips, total)
    # the ranks' largest |input| differ: a per-rank scale would take
    # other levels (and miss the tolerance)
    halves = [np.abs(r["inputs"][0]).max() for r in ranks]
    assert halves[0] != halves[1]

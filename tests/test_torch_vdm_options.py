"""The fine-tune's and the sampler's options in the port (street_crafter_
tpu_torch.models.vdm) against the JAX package's, on the CPU: the fixed
AlphaBlender, the converter's fixed-strategy and LoRA trees, and
``apply_ucg_dropout`` (the remat policies: test_torch_vdm_remat.py). The same seeded numpy inputs; the JAX
parameters (seeded random values) carried across by ``convert``.

Tolerances, with their reasons:
  * f32 forwards (the fixed blender's UNet, the converted trees): 1e-5 of
    the largest |output| (test_torch_vdm_modules.py's F32_RTOL);
  * the fused temporal stages in bf16 against JAX's in interpret mode:
    3e-2 of the largest |output|, median 3e-3 (BF16_MAX, BF16_MED there);
  * the converter's round trips and ``apply_ucg_dropout`` fed JAX's masks:
    equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.vdm import conditioner as JC
from street_crafter_tpu.models.vdm import layers as JL
from street_crafter_tpu.models.vdm.unet import UNetConfig as JUNetConfig
from street_crafter_tpu.models.vdm.unet import VideoUNet as JVideoUNet
from street_crafter_tpu_torch.models.vdm import conditioner as PC
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm import layers as PL
from street_crafter_tpu_torch.models.vdm.unet import UNetConfig, VideoUNet
from street_crafter_tpu_torch.ops import temporal_block as PTB
from tests.test_torch_vdm_modules import (BF16_MAX, BF16_MED, F32_RTOL,
                                          med_err, nchw, rel_err)
from tests.torch_port_helpers import random_params

T, H, W = 2, 32, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int, T: int = T, H: int = H, W: int = W, ctx: int = 48,
            adm: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(T, H, W, 8)).astype(np.float32),
            "t": rng.normal(size=(T,)).astype(np.float32),
            "ctx": rng.normal(size=(T, 1, ctx)).astype(np.float32),
            "y": rng.normal(size=(T, adm)).astype(np.float32),
            "cm": (np.arange(T) == 0).astype(np.float32),
            "g": rng.normal(size=(T, H, W, 4)).astype(np.float32),
            "gs": (np.arange(T) % 2).astype(np.float32),
            "cot": rng.normal(size=(T, H, W, 4)).astype(np.float32)}


def _pair(jcfg: JUNetConfig, pcfg: UNetConfig, inp: dict, seed: int = 0):
    """The JAX UNet with seeded random parameters, and the port's UNet
    holding them (f32, CPU)."""
    jun = JVideoUNet(jcfg)
    params = random_params(jax.eval_shape(
        lambda k: jun.init(k, *map(jnp.asarray, (inp["x"], inp["t"],
                                                 inp["ctx"], inp["y"])),
                           inp["x"].shape[0],
                           cond_mask=jnp.asarray(inp["cm"]),
                           guidance_input=jnp.asarray(inp["g"]),
                           guidance_scale=jnp.asarray(inp["gs"])),
        jax.random.PRNGKey(0)), seed)
    unet = VideoUNet(pcfg)
    unet.load_state_dict(PCV.state_dict_from_jax(
        params, PCV.unet_name_map(pcfg), "unet"))
    return jun, params, unet


def _jax_out(jun, params, inp):
    return jun.apply(params, *map(jnp.asarray, (inp["x"], inp["t"],
                                                inp["ctx"], inp["y"])),
                     inp["x"].shape[0], cond_mask=jnp.asarray(inp["cm"]),
                     guidance_input=jnp.asarray(inp["g"]),
                     guidance_scale=jnp.asarray(inp["gs"]))


def _port_out(unet, inp):
    return unet(*map(torch.tensor, (inp["x"], inp["t"], inp["ctx"],
                                    inp["y"])),
                num_frames=inp["x"].shape[0],
                cond_mask=torch.tensor(inp["cm"]),
                guidance_input=torch.tensor(inp["g"]),
                guidance_scale=torch.tensor(inp["gs"]))


# ------------------------------------------------------- fixed blender

def test_alpha_blender_fixed():
    """"fixed": no parameter, the constant merge factor in the compute
    dtype, as JAX's ``AlphaBlender``."""
    rng = np.random.default_rng(2)
    xs, xt = (rng.normal(size=(2, 3, 4)).astype(np.float32) for _ in "ab")
    for alpha in (0.5, 0.3):
        blend = PL.AlphaBlender(alpha, "fixed")
        assert not list(blend.parameters())
        want = JL.AlphaBlender(alpha, "fixed").apply(
            {}, jnp.asarray(xs), jnp.asarray(xt))
        got = blend(torch.tensor(xs), torch.tensor(xt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
        assert float(blend.coefficient()) == pytest.approx(alpha)
        got16 = blend(torch.tensor(xs).bfloat16(), torch.tensor(xt).bfloat16())
        want16 = JL.AlphaBlender(alpha, "fixed").apply(
            {}, jnp.asarray(xs, jnp.bfloat16), jnp.asarray(xt, jnp.bfloat16))
        np.testing.assert_array_equal(got16.float().numpy(),
                                      np.asarray(want16, np.float32))
    with pytest.raises(ValueError, match="merge_strategy"):
        PL.AlphaBlender(0.5, "learned")


def test_unet_fixed_blender_matches_jax():
    """The tiny UNet under merge_strategy="fixed" (no mixer leaves in
    either package) against JAX's, f32."""
    jcfg = dataclasses.replace(JUNetConfig.tiny(), merge_strategy="fixed",
                               merge_factor=0.3)
    pcfg = dataclasses.replace(UNetConfig.tiny(), merge_strategy="fixed",
                               merge_factor=0.3)
    inp = _inputs(3, T=3, H=16, W=16)
    jun, params, unet = _pair(jcfg, pcfg, inp)
    assert not [n for n, _ in unet.named_parameters() if "mix_factor" in n]
    want = np.asarray(_jax_out(jun, params, inp))
    with torch.no_grad():
        got = _port_out(unet, inp).numpy()
    assert rel_err(got, want) <= F32_RTOL
    # and the learned strategy's output differs: the constant is in use
    learned = VideoUNet(UNetConfig.tiny())
    sd = learned.state_dict()
    sd.update(unet.state_dict())
    learned.load_state_dict(sd)
    with torch.no_grad():
        other = _port_out(learned, inp).numpy()
    assert rel_err(other, want) > 1e-3


@pytest.mark.parametrize("C,heads,dim_head,kernel", [
    (64, 4, 16, "temporal_block_fused_reference"),
    (640, 10, 64, "temporal_attention_fused_reference")])
def test_fused_temporal_fixed_alpha_matches_jax(C, heads, dim_head, kernel):
    """The fused temporal stages (kernel E's plain version at C <= 384, F's
    above) in bf16 with the fixed alpha, against JAX's fused stages with
    merge_strategy="fixed" (``layers.py:491-492``)."""
    rng = np.random.default_rng(4)
    Tf, B, Hs, Ws = 3, 2, 4, 4
    x = rng.normal(size=(B * Tf, Hs, Ws, C)).astype(np.float32)
    ctx = rng.normal(size=(B * Tf, 1, 48)).astype(np.float32)
    jmod = JL.SpatialVideoTransformer(
        heads=heads, dim_head=dim_head, depth=1, context_dim=48,
        fused_temporal=True, dtype="bfloat16", merge_strategy="fixed",
        merge_factor=0.3)
    params = random_params(jax.eval_shape(
        lambda k: jmod.init(k, jnp.asarray(x), jnp.asarray(ctx), Tf),
        jax.random.PRNGKey(4)), 4)
    sd = PCV.state_dict_from_jax({"m": params["params"]},
                                 PCV._transformer_map("m", "m", 1, False))
    pmod = PL.SpatialVideoTransformer(C, heads, dim_head, 1, 48,
                                      merge_factor=0.3, fused_temporal=True,
                                      merge_strategy="fixed")
    pmod.load_state_dict({k[2:]: v for k, v in sd.items()})
    pmod = pmod.to(torch.bfloat16)
    want = np.asarray(jax.jit(jmod.apply, static_argnums=3)(
        params, jnp.asarray(x), jnp.asarray(ctx), Tf), np.float32)
    PTB.reset_launch_counts()
    with torch.no_grad():
        got = np.moveaxis(pmod(nchw(x), torch.tensor(ctx), Tf).float()
                          .numpy(), 1, -1)
    assert PTB.launches == {kernel: 1}
    assert rel_err(got, want) <= BF16_MAX
    assert med_err(got, want) <= BF16_MED


# -------------------------------------------------------------- convert

def _tree_paths(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out |= _tree_paths(v, p) if isinstance(v, dict) else {p}
    return out


@pytest.mark.parametrize("variant", ["fixed", "lora"])
def test_convert_round_trips(variant):
    """A JAX tree of the fixed strategy (no ``time_mixer`` leaf) or of
    ``add_lora`` (its unmerged adapters) loads into the port, gives JAX's
    output, and goes back to the same JAX tree; the port's state dict
    through JAX and back is unchanged."""
    kw = ({"merge_strategy": "fixed"} if variant == "fixed"
          else {"add_lora": True})
    jcfg = dataclasses.replace(JUNetConfig.tiny(), **kw)
    pcfg = dataclasses.replace(UNetConfig.tiny(), **kw)
    inp = _inputs(5, T=3, H=16, W=16)
    jun, params, unet = _pair(jcfg, pcfg, inp, seed=5)
    paths = _tree_paths(params["params"])
    if variant == "fixed":
        assert not [p for p in paths if "time_mixer" in p]
    else:
        assert len([p for p in paths if "_adapter_" in p]) == \
            len([n for n, _ in unet.named_parameters() if "_adapter_" in n])
    want = np.asarray(_jax_out(jun, params, inp))
    with torch.no_grad():
        got = _port_out(unet, inp).numpy()
    assert rel_err(got, want) <= F32_RTOL
    back = PCV.unet_params_to_jax(unet.state_dict(), pcfg)
    assert _tree_paths(back["params"]) == paths
    flat_want = PCV._flatten(params["params"])
    for path, a in PCV._flatten(back["params"]).items():
        np.testing.assert_array_equal(a, flat_want[path], err_msg=path)
    assert np.asarray(_jax_out(jun, back, inp)).tobytes() == want.tobytes()
    again = PCV.state_dict_from_jax(back, PCV.unet_name_map(pcfg))
    for name, t in unet.state_dict().items():
        assert torch.equal(again[name], t), name
    with pytest.raises(ValueError, match="no JAX name"):
        PCV.state_dict_to_jax({"nowhere.weight": torch.zeros(2)},
                              PCV.unet_name_map(pcfg))


# --------------------------------------------------- apply_ucg_dropout

@pytest.mark.parametrize("rate", [0.0, 1.0, 0.5])
def test_ucg_dropout_matches_jax(rate):
    """Fed JAX's Bernoulli keep masks (drawn as ``conditioner.py:84-101``
    draws them), the port's dropout equals JAX's."""
    batch, t = 4, 3
    rng = np.random.default_rng(6)
    leaves = (rng.normal(size=(batch * t, 1, 8)).astype(np.float32),
              rng.normal(size=(batch * t, 6)).astype(np.float32),
              rng.normal(size=(batch * t, 4, 5, 4)).astype(np.float32))
    rates = {"crossattn": rate, "concat": rate}
    key = jax.random.PRNGKey(7)
    want = JC.apply_ucg_dropout(key, JC.Conditioning(
        *map(jnp.asarray, leaves)), rates, batch)
    ks = jax.random.split(key, 3)
    masks = {"crossattn": torch.tensor(np.asarray(jax.random.bernoulli(
                 ks[0], 1 - rate, (batch, 1, 1))).reshape(batch)),
             "concat": torch.tensor(np.asarray(jax.random.bernoulli(
                 ks[1], 1 - rate, (batch, 1, 1, 1))).reshape(batch))}
    got = PC.apply_ucg_dropout(PC.Conditioning(*map(torch.tensor, leaves)),
                               rates, batch, masks=masks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if rate == 0.5:
        # the draw: per clip, from the generator, deterministic in its seed
        draw = functools.partial(PC.ucg_keep_masks, rates, batch)
        m1 = draw(torch.Generator().manual_seed(3))
        m2 = draw(torch.Generator().manual_seed(3))
        assert set(m1) == {"crossattn", "concat"}
        for k in m1:
            assert m1[k].shape == (batch,) and m1[k].dtype == torch.bool
            assert torch.equal(m1[k], m2[k])
        out = PC.apply_ucg_dropout(PC.Conditioning(*map(torch.tensor,
                                                        leaves)),
                                   rates, batch,
                                   torch.Generator().manual_seed(3))
        keep = m1["concat"].repeat_interleave(t)
        np.testing.assert_array_equal(out.concat[~keep].numpy(), 0.0)
        np.testing.assert_array_equal(out.concat[keep].numpy(),
                                      leaves[2][keep.numpy()])
    assert PC.ucg_keep_masks({"crossattn": 0.0}, batch) == {}

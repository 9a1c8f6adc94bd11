"""The port's float32 video diffusion path against the JAX package on the
CPU.

* ``engine_from_config`` with ``diffusion.compute_dtype`` float32 or null
  at full width gives every sub-config (UNet, VAE, CLIP) the dtype JAX's
  gives it, for sampling and for the fine-tune (no weights are built);
* a narrow non-tiny f32 UNet (head dim 64, a 16x16 latent: the level-0
  attention is 256 long, so the JAX package's flash rule fires and the
  port takes ``flash_attention``, here its plain versions) from JAX's
  parameters carried across: the carried values are JAX's f32 values bit
  for bit, and one denoiser output lies within 1e-5 of the largest
  |output| of JAX's (the f32 tolerance of ``test_torch_vdm_modules.py``:
  the same f32 arithmetic in another order);
* the runners' dtype check: bfloat16, float32, null and the tiny engine
  pass, float16 raises (``tests/test_torch_vdm_sample.py`` holds the
  sampler's; this file the fine-tune's), with the engine's construction
  stubbed so that no card is needed;
* the f32 engine runs its UNet, VAE and CLIP calls, and the fine-tune's
  backward, with TF32 off, and leaves the process's setting as it found
  it; a bf16 engine changes nothing.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from street_crafter_tpu.config import default_config as j_default_config
from street_crafter_tpu.models.vdm.clip import \
    CLIPVisualConfig as JCLIPVisualConfig
from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu.models.vdm.unet import UNetConfig as JUNetConfig
from street_crafter_tpu.models.vdm.vae import VAEConfig as JVAEConfig
from street_crafter_tpu.models.vdm.weights import \
    engine_from_config as j_engine_from_config
from street_crafter_tpu_torch.config import default_config
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm.clip import CLIPVisualConfig
from street_crafter_tpu_torch.models.vdm.conditioner import Conditioning
from street_crafter_tpu_torch.models.vdm.engine import (EngineConfig,
                                                        VideoDiffusionEngine)
from street_crafter_tpu_torch.models.vdm.loss import draw_loss
from street_crafter_tpu_torch.models.vdm.unet import UNetConfig
from street_crafter_tpu_torch.models.vdm.vae import VAEConfig
from street_crafter_tpu_torch.models.vdm.weights import (engine_from_config,
                                                         load_state_dicts)
from street_crafter_tpu_torch.ops import flash_attention as PFA
from street_crafter_tpu_torch.runner import vdm_train as VT
from street_crafter_tpu_torch.training.vdm_trainer import (StepDraws,
                                                           VDMTrainer)
from tests.torch_port_helpers import random_params

F32_RTOL = 1e-5
# narrow and not the tiny preset: head dim 64 (one head at level 0, two at
# level 1), attention at levels 0 and 1
NARROW = dict(model_channels=64, num_head_channels=64, channel_mult=(1, 2),
              attention_resolutions=(1, 2), num_res_blocks=1,
              context_dim=48, adm_in_channels=24)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: torch's CPU thread pool costs more than it gives when
    the host is shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dtype", ["float32", None])
def test_engine_from_config_dtypes_match_jax(dtype, training):
    got_cfg, want_cfg = default_config(), j_default_config()
    for c in (got_cfg, want_cfg):
        c.diffusion.compute_dtype = dtype
        c.diffusion.sample_frames = 25
    got = engine_from_config(got_cfg.diffusion, training=training)
    want = j_engine_from_config(want_cfg.diffusion, training=training)
    assert not got_cfg.diffusion.tiny
    for part in ("unet", "vae", "clip"):
        assert getattr(got, part).dtype == getattr(want, part).dtype == dtype
    assert got.unet.model_channels == want.unet.model_channels == 320
    assert got.unet.fused_temporal == want.unet.fused_temporal
    # no weights: the modules on the meta device hold f32 parameters
    with torch.device("meta"):
        eng = VideoDiffusionEngine(got, "meta")
    assert eng.f32
    for module in eng.modules().values():
        assert {p.dtype for p in module.parameters()} == {torch.float32}


@pytest.fixture(scope="module")
def narrow():
    """The JAX engine with a narrow UNet and seeded random parameters, and
    the port's engine holding the same parameters (f32, CPU)."""
    jcfg = JEngineConfig(unet=JUNetConfig(**NARROW), vae=JVAEConfig.tiny(),
                         clip=JCLIPVisualConfig.tiny(), num_frames=2)
    jeng = JEngine(jcfg)
    # the f32 values the JAX engine holds (random_params' kernels are f64)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        random_params(jax.eval_shape(lambda k: jeng.init_params(k, 32, 32),
                                     jax.random.PRNGKey(0)), 7))
    cfg = EngineConfig(unet=UNetConfig(**NARROW), vae=VAEConfig.tiny(),
                       clip=CLIPVisualConfig.tiny(), num_frames=2)
    peng = VideoDiffusionEngine(cfg, "cpu")
    sds = PCV.engine_params_from_jax(params, cfg)
    load_state_dicts(peng, sds)
    return jeng, params, peng, sds


def test_narrow_f32_unet_carries_jax_values_bit_for_bit(narrow):
    jeng, params, peng, sds = narrow
    sd = peng.unet.state_dict()
    for k, p in sd.items():
        assert p.dtype == torch.float32, k
        assert torch.equal(p, torch.as_tensor(sds["unet"][k])), k
    back = PCV.unet_params_to_jax(sd, peng.cfg.unet)
    want = jax.tree_util.tree_leaves_with_path(params["unet"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_narrow_f32_unet_matches_jax(narrow):
    jeng, params, peng, _ = narrow
    rng = np.random.default_rng(5)
    T, B, h = 2, 2, 16
    x = rng.normal(size=(B * T, h, h, 8)).astype(np.float32)
    t = rng.normal(size=(B * T,)).astype(np.float32)
    ctx = rng.normal(size=(B, 1, 48)).astype(np.float32)
    y = rng.normal(size=(B, 24)).astype(np.float32)
    cm = np.array([1, 0, 1, 0], np.float32)
    g = rng.normal(size=(B * T, h, h, 4)).astype(np.float32)
    gs = np.array([0, 0, 1, 1], np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jeng.unet.apply, num_frames=T))(
        params["unet"], *map(jnp.asarray, (x, t, ctx, y)),
        cond_mask=jnp.asarray(cm), guidance_input=jnp.asarray(g),
        guidance_scale=jnp.asarray(gs)))
    PFA.reset_launch_counts()
    with torch.no_grad(), peng.numerics():
        got = peng.unet(*map(torch.tensor, (x, t, ctx, y)), num_frames=T,
                        cond_mask=torch.tensor(cm),
                        guidance_input=torch.tensor(g),
                        guidance_scale=torch.tensor(gs)).numpy()
    # the level-0 spatial attention (256 long, head dim 64) took the flash
    # route: its plain version, on the CPU
    assert PFA.launches["flash_attention_reference"] >= 1
    assert got.dtype == np.float32
    assert got.shape == want.shape == (B * T, h, h, 4)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= F32_RTOL * np.abs(want).max()


class _Built(Exception):
    """Raised by the stubbed engine: the runner got past its check."""


@pytest.mark.parametrize("diffusion", [{"compute_dtype": None},
                                       {"compute_dtype": "float32"},
                                       {"tiny": True},
                                       {"compute_dtype": "float16"}])
def test_vdm_train_checks_the_compute_dtype(diffusion, tmp_path,
                                            monkeypatch):
    """``runner.vdm_train`` builds an f32 (or bf16) engine on cuda and
    refuses float16 before building anything."""
    def stub(ecfg, device, training=False):
        assert torch.device(device).type == "cuda" and training
        raise _Built
    monkeypatch.setattr(VT, "VideoDiffusionEngine", stub)
    cfg = default_config()
    cfg.device = "cuda"
    cfg.model_path = str(tmp_path)
    for k, v in diffusion.items():
        cfg.diffusion[k] = v
    if diffusion.get("compute_dtype") == "float16":
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            VT.build_trainer(cfg)
    else:
        with pytest.raises(_Built):
            VT.build_trainer(cfg)


class _TF32Seen(TorchDispatchMode):
    """The TF32 flags (cuDNN's, the matmuls') at every convolution, forward
    and backward, by op name."""

    OPS = ("convolution", "convolution_backward")

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.OPS:
            self.seen.add((name, torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_f32_engine_scopes_tf32_off(dtype, monkeypatch):
    """TF32 as PyTorch's defaults leave it (cuDNN on, matmuls off) around
    the engine; inside every convolution of the f32 engine's encode, CLIP,
    UNet and decode calls and of its fine-tune step's backward it is off,
    and afterwards it is as before. A bf16 engine leaves it alone."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    base = EngineConfig.tiny(num_frames=2, num_steps=1)
    cfg = dataclasses.replace(
        base, unet=dataclasses.replace(base.unet, dtype=dtype),
        vae=dataclasses.replace(base.vae, dtype=dtype),
        clip=dataclasses.replace(base.clip, dtype=dtype))
    eng = VideoDiffusionEngine(cfg, "cpu", training=True)
    assert eng.f32 == (dtype is None)
    gen = torch.Generator().manual_seed(0)
    for module in eng.modules().values():
        for p in module.parameters():
            p.data.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    img = torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1
    tr = VDMTrainer(eng, {k: p.detach().float().clone()
                          for k, p in eng.unet.named_parameters()}, lr=1e-3)
    lat = torch.randn((1, 2, 4, 4, 4), generator=gen)
    batch = {"latents": lat, "guidance_latents": lat,
             "cond": Conditioning(torch.randn((1, 2, 1, 48), generator=gen),
                                  torch.randn((1, 2, 24), generator=gen),
                                  lat.clone())}
    draws = StepDraws(torch.ones(1), draw_loss((2, 4, 4, 4), 2, gen, "cpu"))
    with _TF32Seen() as mode:
        out = eng.sample(img, img[:1], generator=gen)
        tr.train_step(batch, draws=draws)
    assert out.shape == (2, 16, 16, 3)
    on = not eng.f32
    assert mode.seen == {("convolution", on, False),
                         ("convolution_backward", on, False)}
    assert torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32

"""The port's fine-tune slice (street_crafter_tpu_torch: trainer, remat
policy, runner) on the CPU.

* One whole train step on the tiny engine (f32, T = 2 at 32x32, two clips,
  the recipe's frozen temporal layers) against the JAX package's
  ``make_vdm_train_step``, from a JAX train state that has already taken
  one step (so the Adam moments are not zero), carried across by
  ``convert.vdm_train_state_from_jax``, with the JAX step's random draws
  fed in. Tolerances: the loss within 1e-4 relative; the step's clipped
  gradients (recovered from the first moments) within 1e-3 of each leaf's
  largest (f32 sums in another order); the port's clip, Adam and EMA
  applied to the JAX step's gradients give new masters and EMA within 1e-3
  of each leaf's largest update, the EMA also within 2 f32 ulps of its
  largest |value| (its update, 1e-4 of params - EMA, is often below one
  ulp of the EMA, and the multiply-add rounds or fuses differently);
  temporal leaves bit-identical. The end-to-end masters are not compared
  by update: Adam divides each element's moment by its own root mean
  square, so an element whose gradient is 1e-4 of its leaf's largest
  carries the f32 summation noise into its update (measured 1.01e-3 of
  the leaf's largest update, ROADMAP queue 3). Leaves whose gradient is
  zero by structure (JAX's below 1e-6 of the largest: per-channel
  constants ahead of the tiny config's one-channel GroupNorm) must be
  below the same bound in the port; their updates are rounding noise in
  either framework and are not compared.
* The remat policies' launches (plain versions' counters), the temporal
  attention sites "flashx" keeps, the products "dots" keeps (counted by a
  dispatch mode), and gradients against no remat on a small UNet with
  head dim 64, whose spatial attention reaches the flash path; gradients
  equal to 1e-6 of their largest value (the same operations, run again).
* ``accumulate: 2`` over 2 clips against one batch of 2: the loss within
  1e-5 relative and the first moments (the clipped gradient times 0.1)
  within 1e-4 of each leaf's largest (f32 sums in another order; measured
  3.8e-5 on the AlphaBlender mix factors, scalars summed over every
  activation with cancellation); leaves that are zero by structure (below
  1e-6 of the largest moment) stay below that bound.
* ``runner.vdm_train.main`` writes checkpoints, resumes, and its EMA export
  loads into ``runner.vdm_sample``.
"""

import collections
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from street_crafter_tpu.models.vdm.conditioner import \
    Conditioning as JConditioning
from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu.training.vdm_trainer import (init_vdm_train_state,
                                                     make_vdm_train_step)
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm import weights as PW
from street_crafter_tpu_torch.models.vdm.conditioner import Conditioning
from street_crafter_tpu_torch.models.vdm.engine import (EngineConfig,
                                                        VideoDiffusionEngine)
from street_crafter_tpu_torch.models.vdm.loss import LossDraws
from street_crafter_tpu_torch.models.vdm.unet import UNetConfig, VideoUNet
from street_crafter_tpu_torch.ops import attention as PA
from street_crafter_tpu_torch.ops import flash_attention as PFA
from street_crafter_tpu_torch.training.vdm_trainer import (B1, StepDraws,
                                                           VDMTrainer)
from tests.test_torch_vdm_sample import _synthetic_clip_root
from tests.test_torch_vdm_train_ops import _jax_draws
from tests.torch_port_helpers import random_params

B, T, H, W = 2, 2, 32, 32
LR = 1e-3
EPS32 = float(torch.finfo(torch.float32).eps)
GROUPS = {"slow_temporal_layers": True, "slow_temporal_layers_scale": 0.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it gives when
    the host is shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int, h: int = H // 2, w: int = W // 2) -> dict:
    """A latent training batch of B clips as numpy arrays, [B, T, ...]."""
    rng = np.random.default_rng(seed)

    def r(*shape, sc=1.0):
        return (sc * rng.normal(size=(B, T) + shape)).astype(np.float32)
    return {"latents": r(h, w, 4), "guidance_latents": r(h, w, 4),
            "cond": (r(1, 48), r(24, sc=0.5), r(h, w, 4))}


def _torch_batch(nb: dict) -> dict:
    return {"latents": torch.tensor(nb["latents"]),
            "guidance_latents": torch.tensor(nb["guidance_latents"]),
            "cond": Conditioning(*map(torch.tensor, nb["cond"]))}


def _jax_step_draws(key) -> StepDraws:
    """The draws of JAX's train step from ``key``
    (``vdm_trainer.py:193-198``)."""
    k_drop, k_loss = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 1.0 - 0.15, (B,))
    per_clip = [_jax_draws(k, (T, H // 2, W // 2, 4), T)
                for k in jax.random.split(k_loss, B)]
    return StepDraws(torch.tensor(np.asarray(keep, np.float32)),
                     LossDraws(*(torch.cat(x) for x in zip(*per_clip))))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX: a state after one step, and the next step from it."""
    jeng = JEngine(JEngineConfig.tiny(num_frames=T))
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, H, W), jax.random.PRNGKey(0)), 21)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    nb = _batch(22)
    jb = {"latents": jnp.asarray(nb["latents"]),
          "guidance_latents": jnp.asarray(nb["guidance_latents"]),
          "cond": JConditioning(*map(jnp.asarray, nb["cond"]))}
    step = make_vdm_train_step(jeng, lr=LR, param_groups=GROUPS)
    state0 = init_vdm_train_state(jeng, params, lr=LR, param_groups=GROUPS)
    state1, _ = step(state0, jb, jax.random.PRNGKey(23))
    key = jax.random.PRNGKey(24)
    state2, scalars = step(state1, jb, key)
    return (params, nb, jax.device_get(state1), jax.device_get(state2),
            {k: float(v) for k, v in scalars.items()}, key)


def _port_trainer(params, state, cfg) -> VDMTrainer:
    eng = VideoDiffusionEngine(cfg, "cpu", training=True)
    PW.load_state_dicts(eng, PCV.engine_params_from_jax(params, cfg))
    return VDMTrainer(eng, lr=LR, group_flags={"slow_temporal_layers": True},
                      slow_scale=0.0,
                      state=PCV.vdm_train_state_from_jax(state, cfg))


def test_train_step_matches_jax(jax_steps):
    params, nb, state1, state2, scalars, key = jax_steps
    cfg = EngineConfig.tiny(num_frames=T)
    tr = _port_trainer(params, state1, cfg)
    before = {k: v.clone() for k, v in tr.state.masters.items()}
    mu_before = {k: v.clone() for k, v in tr.state.mu.items()}
    assert tr.state.step == 1 and tr.state.count == {"base": 1, "slow": 1}
    want = PCV.vdm_train_state_from_jax(state2, cfg)
    got = tr.train_step(_torch_batch(nb), draws=_jax_step_draws(key))
    assert abs(got["loss"] - scalars["loss"]) <= 1e-4 * abs(scalars["loss"])
    assert tr.state.step == 2 and tr.state.count == want.count

    # the step's clipped gradients, recovered from the first moments
    grads = {k: tuple((st.mu[k] - B1 * mu_before[k]) / (1 - B1)
                      for st in (tr.state, want)) for k in mu_before}
    g_max = max(float(g[1].abs().max()) for g in grads.values())
    n_temporal, zero = 0, set()
    for name, (gp, gj) in grads.items():
        top = float(gj.abs().max())
        if top <= 1e-6 * g_max:
            # zero by structure (a per-channel constant ahead of the tiny
            # config's one-channel GroupNorm): rounding noise on both sides,
            # which Adam scales up to full-size updates in either framework
            zero.add(name)
            assert float(gp.abs().max()) <= 1e-6 * g_max, name
        else:
            assert float((gp - gj).abs().max()) <= 1e-3 * top, name
        if tr.labels[name] == "slow":
            n_temporal += 1
            assert torch.equal(tr.state.masters[name], before[name]), name
            assert torch.equal(want.masters[name], before[name]), name
        assert torch.equal(tr.params[name].detach(),
                           tr.state.masters[name]), name
    assert n_temporal > 0 and len(zero) < 0.2 * len(grads)

    # the port's clip, Adam and EMA on the JAX step's gradients
    opt = _port_trainer(params, state1, cfg)
    ema_before = {k: v.clone() for k, v in opt.state.ema.items()}
    opt._apply({k: g[1].clone() for k, g in grads.items()})
    for name, new in opt.state.masters.items():
        if opt.labels[name] == "slow":
            assert torch.equal(new, before[name]), name
            continue
        if name in zero:
            continue
        for cur, ref, old, ulps in ((new, want.masters[name], before[name],
                                     0),
                                    (opt.state.ema[name], want.ema[name],
                                     ema_before[name], 2)):
            upd = float((ref - old).abs().max())
            assert upd > 0, name
            # the EMA moves by 1e-4 of (params - EMA), often below one f32
            # ulp of the EMA itself: its multiply-add may round (or fuse)
            # differently, so 2 ulps of the leaf's largest |EMA| are added
            tol = 1e-3 * upd + ulps * EPS32 * float(ref.abs().max())
            assert float((cur - ref).abs().max()) <= tol, name


def _policy_unet(policy: str, remat: bool = True) -> VideoUNet:
    cfg = UNetConfig(model_channels=64, num_head_channels=64,
                     channel_mult=(1, 1), attention_resolutions=(1, 2),
                     context_dim=48, adm_in_channels=24, remat=remat,
                     remat_policy=policy)
    torch.manual_seed(0)
    unet = VideoUNet(cfg)
    with torch.no_grad():        # the zero-initialised layers carry signal
        for p in unet.parameters():
            if not p.abs().sum():
                p.normal_(0.0, 0.02)
    return unet


def _policy_run(unet: VideoUNet):
    """Launches of the forward, of forward + backward, and the gradients
    of one seeded input."""
    g = torch.Generator().manual_seed(1)
    args = (torch.randn((T, H, W, 8), generator=g), torch.tensor([0.3, 0.7]),
            torch.randn((T, 1, 48), generator=g),
            torch.randn((T, 24), generator=g))
    PFA.reset_launch_counts()
    out = unet(*args, num_frames=T, cond_mask=torch.tensor([1.0, 0.0]))
    fwd = dict(PFA.launches)
    (out * torch.randn(out.shape, generator=g)).sum().backward()
    grads = {n: p.grad.clone() for n, p in unet.named_parameters()
             if p.grad is not None}
    return fwd, dict(PFA.launches), grads


def test_flash0_policy_keeps_level0_sites():
    """11 flash sites (5 at level 0, S = 1024; 6 at level 1, S = 256):
    ``flash0`` runs the forward with lse 11 times and recomputes the 6 of
    level 1 in the backward; ``nothing`` recomputes all 11; every site's
    backward is one G and one H; the gradients are those of no remat."""
    site = {"flash_attention_bwd_dkv_reference": 11,
            "flash_attention_bwd_dq_reference": 11}
    fwd, total, g0 = _policy_run(_policy_unet("flash0"))
    assert fwd == {"flash_attention_lse_reference": 11}
    assert total == {"flash_attention_lse_reference": 17, **site}
    _, total, g1 = _policy_run(_policy_unet("nothing"))
    assert total == {"flash_attention_lse_reference": 22, **site}
    _, total, g2 = _policy_run(_policy_unet("flash0", remat=False))
    assert total == {"flash_attention_lse_reference": 11, **site}
    for name, ref in g2.items():
        scale = float(ref.abs().max()) or 1.0
        for g in (g0, g1):
            assert float((g[name] - ref).abs().max()) <= 1e-6 * scale, name
    with torch.no_grad():
        PFA.reset_launch_counts()
        _policy_unet("dots")(torch.zeros((T, H, W, 8)), torch.ones(T),
                             torch.zeros((T, 1, 48)), torch.zeros((T, 24)),
                             num_frames=T)
    assert set(PFA.launches) == {"flash_attention_reference"}
    with pytest.raises(ValueError, match="remat_policy"):
        _policy_run(_policy_unet("offload"))


# the flash sites each policy keeps at this UNet (5 at level 0, 6 at level
# 1): its forward runs the 11 with lse, its backward recomputes the rest
KEPT_SITES = {"nothing": 0, "flash0": 5, "flash01": 11, "flash": 11,
              "flashx": 11, "dots": 0}


class _OpCount(TorchDispatchMode):
    """Counts the aten operators dispatched (a checkpoint's cached outputs
    are not dispatched again)."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _counted_run(policy: str, remat: bool):
    """(operator counts, gradients) of ``_policy_run``, once per
    policy."""
    with _OpCount() as ops:
        _, _, grads = _policy_run(_policy_unet(policy, remat=remat))
    return ops.ops, grads


@pytest.mark.parametrize("policy", list(KEPT_SITES))
def test_remat_policy_sites(policy, monkeypatch):
    """Each remat policy on ``_policy_unet``: the plain forward with lse
    runs 11 times in the forward and 22 less the kept sites in all
    (22 / 17 / 11 / 11 / 11 / 22); "flashx" also keeps the temporal
    attention at q length T and the model's width (here both levels': 64
    channels) and does not run it again, the others recompute it; "dots"
    dispatches the 2-D matrix products (mm, addmm) as often as no remat
    does and bmm and convolutions as often as "nothing". The gradients
    equal those without remat (the same operations; 1e-6 of each leaf's
    largest)."""
    plain = collections.Counter()
    attention_plain = PA.attention_plain

    def counted(q, k, v, scale=None):
        plain[q.shape[1]] += 1
        return attention_plain(q, k, v, scale)

    monkeypatch.setattr(PA, "attention_plain", counted)
    with _OpCount() as ops:
        fwd, total, got = _policy_run(_policy_unet(policy))
    site = {"flash_attention_bwd_dkv_reference": 11,
            "flash_attention_bwd_dq_reference": 11}
    assert fwd == {"flash_attention_lse_reference": 11}
    assert total == {"flash_attention_lse_reference":
                     22 - KEPT_SITES[policy], **site}
    # the temporal attention (q length T) at its 11 sites
    assert plain == {T: 11 if policy == "flashx" else 22}
    ref_ops, want = _counted_run("flash0", False)
    A = torch.ops.aten
    if policy == "dots":
        nothing_ops, _ = _counted_run("nothing", True)
        for op in (A.mm.default, A.addmm.default):
            assert ops.ops[op] == ref_ops[op] < nothing_ops[op]
        for op in (A.bmm.default, A.convolution.default):
            assert ops.ops[op] == nothing_ops[op] > ref_ops[op]
    for name, ref in want.items():
        scale = float(ref.abs().max()) or 1.0
        assert float((got[name] - ref).abs().max()) <= 1e-6 * scale, name


def _tiny_trainer(accumulate: int) -> VDMTrainer:
    eng = VideoDiffusionEngine(EngineConfig.tiny(num_frames=T), "cpu",
                               training=True)
    masters: dict = {}
    PW.init_random_(eng, 0, 1.0, masters)
    return VDMTrainer(eng, masters, lr=LR, accumulate=accumulate,
                      group_flags={"slow_temporal_layers": True},
                      slow_scale=0.0)


def test_accumulation_equals_one_batch():
    batch = _torch_batch(_batch(31))
    g = torch.Generator().manual_seed(32)
    one, two = _tiny_trainer(1), _tiny_trainer(2)
    draws = one.draw(B, (B * T, H // 2, W // 2, 4), g)
    s1 = one.train_step(batch, draws=draws)
    s2 = two.train_step(batch, draws=draws)
    assert abs(s1["loss"] - s2["loss"]) <= 1e-5 * abs(s1["loss"])
    top = max(float(mu.abs().max()) for mu in one.state.mu.values())
    for name, mu in one.state.mu.items():
        scale = float(mu.abs().max())
        if scale <= 1e-6 * top:
            # zero by structure (the tiny config's one-channel GroupNorm)
            assert float(two.state.mu[name].abs().max()) <= 1e-6 * top
            continue
        assert float((two.state.mu[name] - mu).abs().max()) <= 1e-4 * scale
    with pytest.raises(ValueError, match="micro-batches"):
        _tiny_trainer(3).train_step(batch, draws=draws)


def test_vdm_train_main_checkpoints_resumes_and_exports(tmp_path):
    from street_crafter_tpu_torch.config import default_config, load_config
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.runner import vdm_sample, vdm_train
    root = _synthetic_clip_root(str(tmp_path / "data"))
    scene = [d for d in os.listdir(root)
             if os.path.isdir(os.path.join(root, d))]
    prepare_meta(root, scene, "meta_info_train.json")
    out = tmp_path / "out"
    cfg = {"device": "cpu", "model_path": str(out),
           "diffusion": {"tiny": True, "num_steps": 2},
           "vdm_train": {"data_root": root, "height": 32, "width": 48,
                         "num_frames": 3, "samples_per_epoch": 2,
                         "epochs": 1, "ckpt_every": 1, "log_every": 1,
                         "log_images_every": 2, "log_images_steps": 1,
                         "num_workers": 0},
           "render": {"save_video": False}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    res = vdm_train.main(["--config", str(path)])
    tr = res["trainer"]
    assert res["steps"] == 2 and tr.state.step == 2
    assert np.isfinite(res["scalars"]["loss"])
    for it in (1, 2):
        assert (out / "checkpoints" / f"iteration_{it}" /
                "vdm_train_state.pt").exists()
    log = out / "image_log" / "step_00000002"
    for name in ("inputs", "targets", "samples"):
        assert len(os.listdir(log / name)) == 3
    assert (out / "logs" / "metrics.jsonl").exists()

    res2 = vdm_train.main(["--config", str(path),
                           "vdm_train.samples_per_epoch=1"])
    tr2 = res2["trainer"]
    assert res2["steps"] == 1 and tr2.state.step == 3
    assert tr2.state.count == {"base": 3, "slow": 3}
    for name, m in tr.state.masters.items():
        if tr.labels[name] == "slow":
            assert torch.equal(tr2.state.masters[name], m)

    scfg = default_config()
    scfg.merge(load_config(str(path)))
    scfg.diffusion.ckpt_path = res2["ema_path"]
    eng = vdm_sample.build_engine(scfg, 3)
    for name, p in eng.unet.named_parameters():
        assert torch.equal(p, tr2.state.ema[name].to(p.dtype)), name
    prepare_meta(root, scene, "meta_info_val.json")
    sample = vdm_sample.main(["--config", str(path), "--num-clips", "1",
                              f"diffusion.ckpt_path={res2['ema_path']}",
                              f"model_path={tmp_path / 'samples'}"])
    assert np.isfinite(sample["frames"]).all()
    # data-parallel fine-tuning runs on several ranks
    # (tests/test_torch_vdm_dp.py); one process has one, and the frames
    # axis (sequence parallelism) is not ported
    with pytest.raises(ValueError, match="device count"):
        vdm_train.main(["--config", str(path), "mesh.axes.data=2"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vdm_train.main(["--config", str(path), "mesh.axes.frames=2"])


def test_engine_training_flag():
    eng = VideoDiffusionEngine(EngineConfig.tiny(num_frames=T), "cpu",
                               training=True)
    assert all(p.requires_grad for p in eng.unet.parameters())
    assert not any(p.requires_grad for p in eng.vae.parameters())
    assert not any(p.requires_grad for p in eng.clip.parameters())
    assert eng.unet.training and not eng.vae.training
    frozen = VideoDiffusionEngine(EngineConfig.tiny(num_frames=T), "cpu")
    assert not any(p.requires_grad for p in frozen.unet.parameters())
    assert dataclasses.replace(UNetConfig(), remat=True).remat_policy == \
        "flash0"

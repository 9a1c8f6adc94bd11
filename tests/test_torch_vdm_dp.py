"""The port's data-parallel fine-tune (DDP, ZeRO-2, FSDP over two spawned
gloo ranks) on the CPU, at the tiny engine (f32, T = 2 at 32x32, two clips,
the recipe's frozen temporal layers), from one JAX train state that has
taken one step, with the JAX step's draws fed in.

* One step: each mode on two ranks (one clip each) against one process
  with the two clips in ``accumulate: 2``: the gathered masters, moments
  and EMA within 1e-3 of each leaf's update (the same per-clip gradients
  summed in either), the module's weights equal to the masters. Against
  JAX's
  ``make_vdm_train_step`` with B = 2, the tolerances of
  ``tests/test_torch_vdm_train.py``: the loss within 1e-4 relative, the
  clipped gradients (from the first moments) within 1e-3 of each leaf's
  largest, and each mode's sharded clip, Adam and EMA on the JAX step's
  gradients within 1e-3 of each leaf's update (the EMA also 2 ulps of its
  largest |value|).
* Over STEPS steps (ZeRO-2 on two ranks, and one process): the per-step
  loss against JAX's, within DRIFT_TOL relative (the measured drift is in
  ROADMAP queue 3).
* The ZeRO-2 run's checkpoint, written by rank 0, resumes on one process
  bit-equal to the gathered state.
* ``runner.vdm_train.main`` with ``mesh.axes.data=2`` runs on two ranks
  (ZeRO-2) and matches one process with the same global batch; a frames
  axis of 2 does not resolve on one process.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.vdm.conditioner import \
    Conditioning as JConditioning
from street_crafter_tpu.models.vdm.engine import EngineConfig as JEngineConfig
from street_crafter_tpu.models.vdm.engine import \
    VideoDiffusionEngine as JEngine
from street_crafter_tpu.training.vdm_trainer import (init_vdm_train_state,
                                                     make_vdm_train_step)
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm.engine import EngineConfig
from street_crafter_tpu_torch.parallel.mesh import run_ranks
from street_crafter_tpu_torch.training.vdm_trainer import B1
from tests import torch_dp_ranks as R
from tests.test_torch_vdm_train import GROUPS, _batch, _jax_step_draws
from tests.torch_port_helpers import random_params

T, H, W = R.VDM_T, 32, 32
STEPS = 12
# per-step loss drift against JAX, relative: measured at most 1.91e-7 over
# the 12 steps, on one process and on two ranks alike (ROADMAP queue 3);
# the bound is ten times that
DRIFT_TOL = 2e-6
EPS32 = float(torch.finfo(torch.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws_np(d) -> tuple:
    return (d.keep.numpy(), tuple(x.numpy() for x in d.loss))


@pytest.fixture(scope="module")
def jax_run():
    """JAX: a state after one step (key 23), then STEPS steps on the same
    batch with keys 24, 25, ...: the state after the first and every
    step's loss."""
    jeng = JEngine(JEngineConfig.tiny(num_frames=T))
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, H, W), jax.random.PRNGKey(0)), 21)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    nb = _batch(22)
    jb = {"latents": jnp.asarray(nb["latents"]),
          "guidance_latents": jnp.asarray(nb["guidance_latents"]),
          "cond": JConditioning(*map(jnp.asarray, nb["cond"]))}
    step = make_vdm_train_step(jeng, lr=R.VDM_LR, param_groups=GROUPS)
    state = init_vdm_train_state(jeng, params, lr=R.VDM_LR,
                                 param_groups=GROUPS)
    state1, _ = step(state, jb, jax.random.PRNGKey(23))
    state, keys, losses, state2 = state1, [], [], None
    for i in range(STEPS):
        keys.append(jax.random.PRNGKey(24 + i))
        state, scalars = step(state, jb, keys[-1])
        losses.append(float(scalars["loss"]))
        if i == 0:
            state2 = jax.device_get(state)
    cfg = EngineConfig.tiny(num_frames=T)
    sd = {p: {k: v.numpy() for k, v in s.items()}
          for p, s in PCV.engine_params_from_jax(params, cfg).items()}
    s1 = PCV.vdm_train_state_from_jax(jax.device_get(state1), cfg)
    want = PCV.vdm_train_state_from_jax(state2, cfg)
    grads = {k: ((want.mu[k] - B1 * s1.mu[k]) / (1 - B1)).numpy()
             for k in s1.mu}
    return dict(sd=sd, state1=R.vdm_state_numpy(s1),
                state2=R.vdm_state_numpy(want), nb=nb, grads=grads,
                draws=[_draws_np(_jax_step_draws(k)) for k in keys],
                losses=losses)


@pytest.fixture(scope="module")
def runs(jax_run, tmp_path_factory):
    """The port: one process, and two ranks (checkpoint under ``ckpt``)."""
    j = jax_run
    ckpt = tmp_path_factory.mktemp("vdm_dp_ckpt")
    args = (j["sd"], j["state1"], j["nb"], j["draws"][0], j["grads"],
            j["draws"])
    one = R.vdm_dp(None, *args, None)
    ranks = run_ranks(R.vdm_dp, 2, str(ckpt), *args, str(ckpt),
                      timeout_s=400)
    return dict(one=one, ranks=ranks, ckpt=str(ckpt))


def _by_update(got: dict, want: dict, before: dict, skip=(), ulps=0):
    """Every leaf of ``got`` within 1e-3 of the leaf's update (``want`` -
    ``before``), plus ``ulps`` f32 ulps of its largest |value|."""
    for n, w in want.items():
        if n in skip:
            continue
        upd = float(np.abs(w - before[n]).max())
        tol = 1e-3 * upd + ulps * EPS32 * float(np.abs(w).max())
        assert float(np.abs(got[n] - w).max()) <= tol, n


def _zero_by_structure(grads: dict) -> set:
    top = max(float(np.abs(g).max()) for g in grads.values())
    return {n for n, g in grads.items() if np.abs(g).max() <= 1e-6 * top}


def test_modes_match_one_process(jax_run, runs):
    before = jax_run["state1"]
    one = runs["one"]["one"]["state"]
    for mode in ("ddp", "zero2", "fsdp"):
        got = [r[mode] for r in runs["ranks"]]
        for field in ("masters", "mu", "nu", "ema"):
            for n in got[0]["state"][field]:
                np.testing.assert_array_equal(got[1]["state"][field][n],
                                              got[0]["state"][field][n])
            _by_update(got[0]["state"][field], one[field], before[field])
        assert got[0]["state"]["count"] == one["count"]
        assert got[0]["state"]["step"] == one["step"] == before["step"] + 1
        assert got[0]["loss"] == pytest.approx(runs["one"]["one"]["loss"],
                                               rel=1e-6)
        for g in got:
            for n, m in g["state"]["masters"].items():
                np.testing.assert_array_equal(g["module"][n], m)


def test_modes_match_jax(jax_run, runs):
    j = jax_run
    before, want = j["state1"], j["state2"]
    zero = _zero_by_structure(j["grads"])
    assert len(zero) < 0.2 * len(j["grads"])
    g_max = max(float(np.abs(g).max()) for g in j["grads"].values())
    for res in [runs["one"]["one"]] + [runs["ranks"][0][m] for m in
                                       ("ddp", "zero2", "fsdp")]:
        assert abs(res["loss"] - j["losses"][0]) <= 1e-4 * abs(j["losses"][0])
        st = res["state"]
        for n, gj in j["grads"].items():
            gp = (st["mu"][n] - B1 * before["mu"][n]) / (1 - B1)
            top = float(np.abs(gj).max())
            if n in zero:
                assert float(np.abs(gp).max()) <= 1e-6 * g_max, n
            else:
                assert float(np.abs(gp - gj).max()) <= 1e-3 * top, n
        applied = res["applied"]
        _by_update(applied["masters"], want["masters"], before["masters"],
                   skip=zero)
        _by_update(applied["ema"], want["ema"], before["ema"], skip=zero,
                   ulps=2)


def test_loss_drift_over_steps(jax_run, runs):
    want = np.asarray(jax_run["losses"])
    for got in (runs["one"]["steps"]["losses"],
                runs["ranks"][0]["steps"]["losses"]):
        drift = np.abs(np.asarray(got) - want) / np.abs(want)
        assert drift.max() <= DRIFT_TOL, drift
    np.testing.assert_array_equal(runs["ranks"][1]["steps"]["losses"],
                                  runs["ranks"][0]["steps"]["losses"])


def test_zero2_checkpoint_resumes_on_one_process(jax_run, runs):
    from street_crafter_tpu_torch.training.vdm_trainer import VDMTrainer
    from street_crafter_tpu_torch.utils.checkpoint import load_vdm_checkpoint
    gathered = runs["ranks"][0]["steps"]["state"]
    state, it = load_vdm_checkpoint(runs["ckpt"])
    assert it == gathered["step"] == jax_run["state1"]["step"] + STEPS
    got = R.vdm_state_numpy(state)
    assert got["count"] == gathered["count"]
    for field in ("masters", "mu", "nu", "ema"):
        assert sorted(got[field]) == sorted(gathered[field])
        for n, a in gathered[field].items():
            np.testing.assert_array_equal(got[field][n], a)
    tr = VDMTrainer(R.vdm_engine(jax_run["sd"]), lr=R.VDM_LR,
                    group_flags=R.VDM_FLAGS, slow_scale=0.0, state=state)
    for n, p in tr.params.items():
        assert torch.equal(p.detach(), state.masters[n]), n
    sc = tr.train_step(R.vdm_batch(jax_run["nb"], None),
                       draws=R.vdm_draws(jax_run["draws"][0]))
    assert np.isfinite(sc["loss"]) and tr.state.step == it + 1


def test_vdm_train_main_on_two_ranks(tmp_path):
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.runner import vdm_train
    from tests.test_torch_vdm_sample import _synthetic_clip_root
    root = _synthetic_clip_root(str(tmp_path / "data"))
    scene = [d for d in os.listdir(root)
             if os.path.isdir(os.path.join(root, d))]
    prepare_meta(root, scene, "meta_info_train.json")
    cfg = {"device": "cpu", "resume": False,
           "diffusion": {"tiny": True, "num_steps": 2},
           "vdm_train": {"data_root": root, "height": 32, "width": 48,
                         "num_frames": 3, "batch_size": 2,
                         "samples_per_epoch": 2, "epochs": 1,
                         "ckpt_every": 2, "log_every": 1,
                         "log_images_every": 0, "num_workers": 0}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    # one process in micro-batches of one clip: the per-clip gradients
    # that the ranks sum
    one = R.vdm_train_main(None, str(path),
                           [f"model_path={tmp_path / 'one'}",
                            "vdm_train.accumulate=2"])
    ranks = run_ranks(R.vdm_train_main, 2, str(tmp_path), str(path),
                      [f"model_path={tmp_path / 'two'}", "mesh.axes.data=2"],
                      timeout_s=180)
    # the initial masters (the seeded random init), for each leaf's update
    from street_crafter_tpu_torch.config import default_config, load_config
    icfg = default_config()
    icfg.merge(load_config(str(path)))
    icfg.model_path = str(tmp_path / "init")
    init = {n: t.numpy() for n, t in
            vdm_train.build_trainer(icfg)[0].state.masters.items()}
    for r in ranks:
        assert r["steps"] == one["steps"] == 2
        assert r["scalars"]["loss"] == pytest.approx(one["scalars"]["loss"],
                                                     rel=1e-5)
        # the ranks encode one clip each, the process both in one batch
        _by_update(r["state"]["masters"], one["state"]["masters"], init)
    assert sorted(os.listdir(tmp_path / "two" / "checkpoints")) == \
        ["iteration_2"]
    assert (tmp_path / "two" / "ema_params.pt").exists()
    # the frames axis runs on ranks of its own
    # (tests/test_torch_vdm_sp.py); one process has no second rank for it
    with pytest.raises(ValueError, match="not divisible"):
        vdm_train.main(["--config", str(path), "mesh.axes.frames=2",
                        f"model_path={tmp_path / 'three'}"])

"""The port's frames-sharded fine-tune (the JAX step on a ``{data,
frames}`` mesh) on the CPU over spawned gloo ranks: the tiny engine (f32,
T = 4 at 32x32, two clips, the recipe's frozen temporal layers), from one
JAX train state that has taken one step, with the JAX step's draws fed in
for four more steps.

* ``{frames: 2}`` under ZeRO-2 with the flash0 remat policy, and ``{data:
  2, frames: 2}`` under ZeRO-2 and FSDP with flashx (whose temporal
  attention sites take the clip's T): every step's loss within 2e-6
  relative of JAX's ``make_vdm_train_step`` on one device (the drift
  bound of ``tests/test_torch_vdm_dp.py``), and the gathered masters and
  EMA within 1e-3 of each leaf's update (the EMA with 2 f32 ulps of its
  largest |value|, as
  ``tests/test_torch_vdm_dp.py``), the moments within 1e-4 of each leaf's
  largest |value|, of the port's one-process run over the same steps (the
  frames ranks sum the parts of one loss where one process has the whole:
  the same addends in another order); the module's weights equal to the
  masters, every rank's state equal. Leaves whose gradient is zero by
  structure (first moments below 1e-6 of the largest, as in
  ``tests/test_torch_vdm_train.py``) must stay below that bound; their
  updates are rounding noise in either run and are not compared.
* ``runner.vdm_train.main`` on ``{data: 1, frames: 2}``: rank 0's
  checkpoint holds the one-process run's masters within 1e-3 of each
  leaf's update (with 2 f32 ulps of slack: two steps at the recipe's lr
  1e-5 move a master by about a thousand ulps) and its moments as above.
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
from street_crafter_tpu_torch.models.vdm.loss import LossDraws
from street_crafter_tpu_torch.parallel.mesh import run_ranks
from street_crafter_tpu_torch.training.vdm_trainer import StepDraws
from tests import torch_dp_ranks as R
from tests import torch_sp_ranks as SR
from tests.test_torch_vdm_dp import _by_update
from tests.test_torch_vdm_train import GROUPS
from tests.test_torch_vdm_train_ops import _jax_draws
from tests.torch_port_helpers import random_params

B, T, H, W = 2, SR.VDM_T, 32, 32
STEPS = 4
DRIFT_TOL = 2e-6
# the moments: of each leaf's largest |value| (tests/test_torch_vdm_train's
# accumulate bound: f32 sums in another order, the mixers' scalars summed
# over every activation with cancellation)
MOMENT_RTOL = 1e-4
FIELDS = ("masters", "mu", "nu", "ema")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def r(*shape, sc=1.0):
        return (sc * rng.normal(size=(B, T) + shape)).astype(np.float32)
    return {"latents": r(H // 2, W // 2, 4),
            "guidance_latents": r(H // 2, W // 2, 4),
            "cond": (r(1, 48), r(24, sc=0.5), r(H // 2, W // 2, 4))}


def _step_draws(key) -> tuple:
    """The draws of JAX's train step from ``key`` (numpy)."""
    k_drop, k_loss = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 1.0 - 0.15, (B,))
    per_clip = [_jax_draws(k, (T, H // 2, W // 2, 4), T)
                for k in jax.random.split(k_loss, B)]
    d = StepDraws(torch.tensor(np.asarray(keep, np.float32)),
                  LossDraws(*(torch.cat(x) for x in zip(*per_clip))))
    return d.keep.numpy(), tuple(x.numpy() for x in d.loss)


@pytest.fixture(scope="module")
def jax_run():
    """JAX: a state after one step (key 31), then STEPS steps with keys
    32, 33, ...: the state after the first step and every step's loss."""
    jeng = JEngine(JEngineConfig.tiny(num_frames=T))
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, H, W), jax.random.PRNGKey(0)), 29)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    nb = _batch(30)
    jb = {"latents": jnp.asarray(nb["latents"]),
          "guidance_latents": jnp.asarray(nb["guidance_latents"]),
          "cond": JConditioning(*map(jnp.asarray, nb["cond"]))}
    step = make_vdm_train_step(jeng, lr=R.VDM_LR, param_groups=GROUPS)
    state = init_vdm_train_state(jeng, params, lr=R.VDM_LR,
                                 param_groups=GROUPS)
    state1, _ = step(state, jb, jax.random.PRNGKey(31))
    state, keys, losses = state1, [], []
    for i in range(STEPS):
        keys.append(jax.random.PRNGKey(32 + i))
        state, scalars = step(state, jb, keys[-1])
        losses.append(float(scalars["loss"]))
    cfg = EngineConfig.tiny(num_frames=T)
    sd = {p: {k: v.numpy() for k, v in s.items()}
          for p, s in PCV.engine_params_from_jax(params, cfg).items()}
    s1 = PCV.vdm_train_state_from_jax(jax.device_get(state1), cfg)
    return dict(sd=sd, state1=R.vdm_state_numpy(s1), nb=nb,
                draws=[_step_draws(k) for k in keys], losses=losses)


RUNS = {"frames2_zero2": ({"frames": 2}, "zero2", "flash0", 2),
        "data2_frames2_zero2": ({"data": 2, "frames": 2}, "zero2",
                                "flashx", 4),
        "data2_frames2_fsdp": ({"data": 2, "frames": 2}, "fsdp",
                               "flashx", 4)}


@pytest.fixture(scope="module")
def runs(jax_run, tmp_path_factory):
    j = jax_run
    args = (j["sd"], j["state1"], j["nb"], j["draws"])
    tmp = str(tmp_path_factory.mktemp("vdm_sp"))
    out = {"one": SR.vdm_sp_steps(None, None, "zero2", "flash0", *args)}
    two = run_ranks(SR.suite, 2, tmp, [
        ("frames2_zero2", "vdm_sp_steps", ({"frames": 2}, "zero2", "flash0")
         + args)], timeout_s=400)
    four = run_ranks(SR.suite, 4, tmp, [
        (name, "vdm_sp_steps", (spec, mode, policy) + args)
        for name, (spec, mode, policy, n) in RUNS.items() if n == 4],
        timeout_s=400)
    for name, (_, _, _, n) in RUNS.items():
        out[name] = [r[name] for r in (two if n == 2 else four)]
    return out


def _by_largest(got: dict, want: dict, skip=(), rtol=MOMENT_RTOL):
    for n, w in want.items():
        if n not in skip:
            tol = rtol * float(np.abs(w).max())
            assert float(np.abs(got[n] - w).max()) <= tol, n


def test_one_process_loss_matches_jax(jax_run, runs):
    want = np.asarray(jax_run["losses"])
    drift = np.abs(np.asarray(runs["one"]["losses"]) - want) / np.abs(want)
    assert drift.max() <= DRIFT_TOL, drift


@pytest.mark.parametrize("name", list(RUNS))
def test_frames_sharded_steps(jax_run, runs, name):
    want = np.asarray(jax_run["losses"])
    one = runs["one"]["state"]
    before = jax_run["state1"]
    ranks = runs[name]
    got = ranks[0]
    drift = np.abs(np.asarray(got["losses"]) - want) / np.abs(want)
    assert drift.max() <= DRIFT_TOL, drift
    assert got["state"]["step"] == before["step"] + STEPS
    assert got["state"]["count"] == one["count"]
    # leaves whose gradient is zero by structure (per-channel constants
    # ahead of the tiny config's one-channel GroupNorm): their moments are
    # rounding noise that Adam turns into steps in either run; they stay
    # below the same bound here
    top = max(float(np.abs(m).max()) for m in one["mu"].values())
    zero = {n for n, m in one["mu"].items() if np.abs(m).max() <= 1e-6 * top}
    assert len(zero) < 0.2 * len(one["mu"])
    for n in zero:
        assert np.abs(got["state"]["mu"][n]).max() <= 1e-6 * top, n
    _by_update(got["state"]["masters"], one["masters"], before["masters"],
               skip=zero)
    _by_update(got["state"]["ema"], one["ema"], before["ema"], skip=zero,
               ulps=2)
    for field in ("mu", "nu"):
        _by_largest(got["state"][field], one[field], skip=zero)
    for r in ranks[1:]:
        assert r["losses"] == got["losses"]
        for field in FIELDS:
            for n, a in got["state"][field].items():
                np.testing.assert_array_equal(r["state"][field][n], a)
    for r in ranks:
        for n, m in got["state"]["masters"].items():
            np.testing.assert_array_equal(r["module"][n], m)


def test_vdm_train_main_on_frames_mesh(tmp_path):
    from street_crafter_tpu_torch.config import default_config, load_config
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.runner import vdm_train
    from street_crafter_tpu_torch.utils.checkpoint import load_vdm_checkpoint
    from tests.test_torch_vdm_sample import _synthetic_clip_root
    root = _synthetic_clip_root(str(tmp_path / "data"))
    scene = [d for d in os.listdir(root)
             if os.path.isdir(os.path.join(root, d))]
    prepare_meta(root, scene, "meta_info_train.json")
    cfg = {"device": "cpu", "resume": False,
           "diffusion": {"tiny": True, "num_steps": 2},
           "vdm_train": {"data_root": root, "height": 32, "width": 48,
                         "num_frames": T, "batch_size": 1,
                         "samples_per_epoch": 2, "epochs": 1,
                         "ckpt_every": 2, "log_every": 1,
                         "log_images_every": 0, "num_workers": 0}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    one = R.vdm_train_main(None, str(path),
                           [f"model_path={tmp_path / 'one'}"])
    ranks = run_ranks(R.vdm_train_main, 2, str(tmp_path), str(path),
                      [f"model_path={tmp_path / 'two'}",
                       "mesh.axes.data=1", "mesh.axes.frames=2"],
                      timeout_s=300)
    icfg = default_config()
    icfg.merge(load_config(str(path)))
    icfg.model_path = str(tmp_path / "init")
    init = {n: t.numpy() for n, t in
            vdm_train.build_trainer(icfg)[0].state.masters.items()}
    assert ranks[0]["steps"] == one["steps"] == 2
    assert sorted(os.listdir(tmp_path / "two" / "checkpoints")) == \
        ["iteration_2"]
    want, it = load_vdm_checkpoint(str(tmp_path / "one"))
    got, it2 = load_vdm_checkpoint(str(tmp_path / "two"))
    assert it == it2 == 2
    want, got = R.vdm_state_numpy(want), R.vdm_state_numpy(got)
    assert got["count"] == want["count"]
    top = max(float(np.abs(m).max()) for m in want["mu"].values())
    zero = {n for n, m in want["mu"].items()
            if np.abs(m).max() <= 1e-6 * top}
    # the recipe's lr 1e-5 moves a master by ~1e-5 in two steps: one f32
    # ulp of the master is ~1e-3 of that, so 2 ulps of slack on top
    _by_update(got["masters"], want["masters"], init, skip=zero, ulps=2)
    for field in ("mu", "nu"):
        _by_largest(got[field], want[field], skip=zero)
    for r in ranks:
        assert r["scalars"]["loss"] == pytest.approx(one["scalars"]["loss"],
                                                     rel=1e-5)

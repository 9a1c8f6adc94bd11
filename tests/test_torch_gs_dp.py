"""The port's camera-batched GS step (``make_train_step(batch_size=B,
mesh=)``) on the CPU, from one JAX train state on the tiny scene of
``tests/test_gs_dp_train.py``:

* B = 2 on one process against JAX's ``make_train_step(batch_size=2)``
  (mesh None): the loss within 2e-4 relative (the one-step tolerance of
  ``tests/test_torch_train.py``),
  the parameters, the first and second Adam moments within 2e-3 of each
  leaf's largest |value|, the densify statistics (sums of both cameras,
  radii the maximum) likewise; the camera's draws are JAX's (no flips: no
  actors).
* The duplicated-camera identities of JAX's
  ``test_dp_matches_single_on_duplicated_camera``: the B = 2 step on one
  camera twice moves the parameters as the single step does (1e-6), the
  visibility counts and gradient sums double, the radii do not.
* Two gloo ranks against one process, both at B = 2, over 5 steps with a
  densify after the third: every leaf within 1e-5 of the leaf's largest
  |value| (the ranks sum the two cameras' gradients where one process
  accumulates them: the same two f32 addends), and the two ranks' states
  bit-equal.
* ``runner.train.main`` with ``train.batch_size=2`` for 6 iterations
  across a densify on one process and on two ranks: the ranks' states
  bit-equal, and equal to the one-process run's to 1e-5 of each leaf's
  largest |value|.
* ``make_sharded_renderer`` on one process and two ranks: equal outputs,
  each view equal to the single-camera render and within the raster's
  2e-3 of JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from street_crafter_tpu.training.gs_trainer import (
    init_train_state as j_init_train_state, make_train_step as j_make_step)
from street_crafter_tpu_torch.config import Config, to_dict
from street_crafter_tpu_torch.models.gs.convert import (
    train_state_from_dict, train_state_to_numpy)
from street_crafter_tpu_torch.parallel.mesh import run_ranks
from street_crafter_tpu_torch.training.gs_trainer import make_train_step
from tests import torch_dp_ranks as R
from tests.test_gs_dp_train import _batch, _stack_batches, _stack_cams
from tests.test_gs_train_e2e import make_cameras, make_params, render_gt
from tests.torch_port_helpers import jax_tree_to_numpy

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The tiny scene: JAX's state, cameras (as arrays), targets, config
    (JAX's tiny-scene settings, caps above the splat count)."""
    from street_crafter_tpu.config import default_config
    rng = np.random.default_rng(0)
    cfg = default_config()
    cfg.optim.position_lr_init = 0.002
    cfg.optim.position_lr_final = 0.0002
    cfg.optim.feature_lr = 0.02
    cfg.optim.opacity_lr = 0.05
    cfg.optim.scaling_lr = 0.01
    cfg.render.max_intersects_per_tile = 32
    cfg.render.tile_size = 16
    true_params = make_params(rng)
    jcams = make_cameras()
    jcams.append(dataclasses.replace(jcams[0], T=jcams[0].T + 0.2))
    targets = [np.asarray(render_gt(true_params, c)) for c in jcams]
    params = make_params(rng, jitter=0.25)
    jstate = j_init_train_state(params)
    cams = [(np.asarray(c.w2c), np.asarray(c.K), c.width, c.height)
            for c in jcams]
    return dict(cfg=cfg, pcfg=Config(to_dict(cfg)), jcams=jcams, cams=cams,
                targets=targets, jstate=jstate,
                state0=jax_tree_to_numpy(jstate))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (np.abs(np.asarray(b)).max() + 1e-20))


def _port_step(s, idx, batch_size=2):
    state = train_state_from_dict(s["state0"])
    step = make_train_step(s["pcfg"], None, spatial_lr_scale=1.0,
                           batch_size=batch_size)
    cams, batches = R.gs_cameras(s["cams"]), R.gs_batches(s["targets"])
    if batch_size == 1:
        _, sc = step(state, cams[idx[0]], batches[idx[0]])
    else:
        _, sc = step(state, [cams[i] for i in idx],
                     [batches[i] for i in idx])
    return train_state_to_numpy(state), {k: float(v) for k, v in sc.items()}


def test_batch_step_matches_jax(setup):
    s = setup
    jstep = j_make_step(s["cfg"], None, spatial_lr_scale=1.0, batch_size=2)
    js, jsc = jstep(s["jstate"], _stack_cams([s["jcams"][0], s["jcams"][1]]),
                    _stack_batches([_batch(s["targets"][0]),
                                    _batch(s["targets"][1])]),
                    jax.random.PRNGKey(3))
    want = jax_tree_to_numpy(js)
    got, sc = _port_step(s, [0, 1])
    assert sorted(sc) == sorted(jsc)
    for k, v in jsc.items():
        assert sc[k] == pytest.approx(float(v), rel=2e-4), k
    assert int(got["step"]) == int(want["step"]) == 1
    for k in LEAVES:
        assert _rel(got["params"]["bkgd"][k], want["params"]["bkgd"][k]) \
            < 2e-3, k
    for k in want["adam_bkgd"]["m"]:
        for mom in ("m", "v"):
            assert _rel(got["adam_bkgd"][mom][k], want["adam_bkgd"][mom][k]) \
                < 2e-3, (mom, k)
    d, w = got["dstate_bkgd"], want["dstate_bkgd"]
    np.testing.assert_array_equal(d["denom"], w["denom"])
    assert w["denom"].max() == 2          # both cameras see a splat: a sum
    np.testing.assert_allclose(d["max_radii2d"], w["max_radii2d"], atol=1e-6)
    for k in ("grad_accum", "grad_abs_accum"):
        assert _rel(d[k], w[k]) < 2e-3, k


def test_duplicated_camera_identities(setup):
    single, sc1 = _port_step(setup, [0], batch_size=1)
    dup, sc2 = _port_step(setup, [0, 0])
    assert sc2["loss"] == pytest.approx(sc1["loss"], rel=1e-5)
    np.testing.assert_allclose(dup["params"]["bkgd"]["xyz"],
                               single["params"]["bkgd"]["xyz"], atol=1e-6)
    d, s1 = dup["dstate_bkgd"], single["dstate_bkgd"]
    np.testing.assert_allclose(d["denom"], 2 * s1["denom"], atol=1e-6)
    np.testing.assert_allclose(d["grad_accum"], 2 * s1["grad_accum"],
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(d["max_radii2d"], s1["max_radii2d"],
                               atol=1e-6)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif tree is not None:
        yield path, np.asarray(tree)


def _assert_close(got, want, rtol=1e-5):
    for (p, a), (q, b) in zip(_leaves(got), _leaves(want)):
        assert p == q
        if a.dtype == bool or a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=p)
        else:
            assert np.abs(a - b).max() <= rtol * np.abs(b).max(), p


def _assert_equal(got, want):
    for (p, a), (q, b) in zip(_leaves(got), _leaves(want)):
        assert p == q
        np.testing.assert_array_equal(a, b, err_msg=p)


ORDER = [[0, 1], [2, 3], [1, 2], [3, 0], [0, 2]]


def test_two_ranks_match_one_process_across_densify(setup, tmp_path):
    s = setup
    args = (to_dict(s["pcfg"]), s["state0"], s["cams"], s["targets"], ORDER,
            2, 1e-7)
    one = R.gs_steps(None, *args)
    assert one["n_valid"][0][1] > one["n_valid"][0][0]   # densify grew
    ranks = run_ranks(R.gs_steps, 2, str(tmp_path), *args, timeout_s=180)
    _assert_equal(ranks[1]["state"], ranks[0]["state"])
    assert ranks[0]["n_valid"] == one["n_valid"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5)
    _assert_close(ranks[0]["state"], one["state"])


@pytest.fixture(scope="module")
def scene_config(tmp_path_factory):
    """The port's synthetic scene with test_torch_train's settings and a
    compressed schedule: 6 iterations, densify at 4, checkpoint at 6."""
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from tests.test_torch_train import slice_config
    root = tmp_path_factory.mktemp("gs_dp_main")
    cfg = slice_config(default_config())
    cfg.device = "cpu"
    cfg.source_path = make_scene(str(root), num_frames=3)
    cfg.model.gaussian.flip_prob = 0.2
    o = cfg.optim
    o.densify_from_iter, o.densification_interval = 4, 4
    o.densify_until_iter, o.opacity_reset_interval = 5, 100
    o.densify_grad_threshold = 1e-7
    cfg.train.iterations = 6
    cfg.train.test_iterations = [6]
    cfg.train.checkpoint_iterations = [6]
    cfg.train.save_iterations = []
    cfg.train.log_interval = 2
    cfg.resume = False
    path = str(root / "scene.json")
    save_config(cfg, path)
    return root, path


def test_train_main_batch_of_two(scene_config):
    import os
    root, path = scene_config
    one = R.gs_train_main(None, path, str(root / "one"),
                          ["train.batch_size=2"])
    ranks = run_ranks(R.gs_train_main, 2, str(root), path,
                      str(root / "two"), ["train.batch_size=2"],
                      timeout_s=240)
    assert [r["rank"] for r in ranks] == [0, 1]
    _assert_equal(ranks[1]["state"], ranks[0]["state"])
    _assert_close(ranks[0]["state"], one["state"])
    assert int(one["state"]["step"]) == 6
    # rank 0 alone wrote the checkpoint, the logs and the eval image
    assert os.listdir(root / "two" / "checkpoints") == ["iteration_6"]
    lines = (root / "two" / "logs" / "metrics.jsonl").read_text()
    assert len(lines.splitlines()) == 4      # logs at 2, 4, 6 and the eval


def test_sharded_render(tmp_path):
    """``make_sharded_renderer`` (JAX's test_sharded_render_matches_single's
    scene: 512 splats, 8 cameras at 32x32) on one process and on two
    ranks: the same [8, H, W, .] outputs, and each view equal to the
    port's single-camera render and within the raster's 2e-3 of JAX's."""
    from street_crafter_tpu.datasets.cameras import Camera as JCamera
    from street_crafter_tpu.models.gs.renderer import render_scene as j_render
    from street_crafter_tpu_torch.models.gs.convert import params_from_dict
    from street_crafter_tpu_torch.models.gs.renderer import render_scene
    from tests.test_batch_render import _scene
    jparams = _scene(np.random.default_rng(0))
    params = jax_tree_to_numpy(jparams)
    K = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
    jcams = []
    for i in range(8):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.2 * i
        jcams.append(JCamera.from_c2w(c2w, K, 32, 32, frame=i, cam=0))
    cams = [(np.asarray(c.w2c), K, 32, 32) for c in jcams]
    one = R.batch_render(None, params, cams)
    assert one["rgb"].shape == (8, 32, 32, 3)
    assert one["counts"] == {"tile_worklist_reference": 8,
                             "composite_reference": 8}
    ranks = run_ranks(R.batch_render, 2, str(tmp_path), params, cams,
                      timeout_s=120)
    for r in ranks:
        assert r["counts"] == {"tile_worklist_reference": 4,
                               "composite_reference": 4}
        for k in ("rgb", "depth", "acc"):
            np.testing.assert_array_equal(r[k], one[k])
    p = params_from_dict(params)
    ref = render_scene(p, None, R.gs_cameras(cams)[3], sh_degree=1,
                       interpolate_pose=True, clamp=True)
    np.testing.assert_array_equal(one["rgb"][3], ref["rgb"].numpy())
    jref = j_render(jparams, None, jcams[3], sh_degree=1, max_per_tile=512,
                    interpolate_pose=True, clamp=True)
    np.testing.assert_allclose(one["rgb"][3], np.asarray(jref["rgb"]),
                               atol=2e-3)

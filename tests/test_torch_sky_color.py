"""Port parity for the cubemap sky and the pose-conditioned colour MLP of
street_crafter_tpu_torch, against the JAX package on the CPU.

- ``ops.cubemap``: ``sample_cubemap`` values and gradients (to the texture
  and to the directions) on the inputs of tests/test_image_ops.py, plus
  directions exactly on face ties, edges and corners; ``latlong_from_
  cubemap``. Both sides run the same f32 operations in the same order:
  values to CUBE_ATOL, gradients to CUBE_GRAD_RTOL of their largest.
- ``render_scene`` with a cubemap, with the MLP (and the sky's MLP) and
  with both, on the scenes of tests/test_scene_render.py, at two cameras:
  rgb and acc to the raster's bound (tests/test_torch_render.py), the sky
  lookup and the affines to 1e-6, and the gradients of the texture and of
  every MLP leaf of sum(rgb^2) to RENDER_GRAD_RTOL.
- GS training on the tiny 64x48 scene with cubemap + MLP + use_sky, from
  a JAX train state: one step's loss terms (2e-4 relative) and the
  gradients of the texture and of every MLP leaf (2e-3 of each leaf's
  largest), tests/test_torch_train.py's tolerances; then the JAX and the
  port trainer loops over N_ITERS iterations from that state,
  per-iteration losses within LOSS_RTOL (the drift is printed).
- The train state's conversion carries the new leaves and their moments
  both ways; ``runner.train.main`` with all four features of the slice
  (cubemap, MLP, sky MLP, COLMAP points) trains, writes the latlong PNG,
  checkpoints and resumes them.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.torch_port_helpers import jax_scene_from_numpy, jax_tree_to_numpy

torch.set_num_threads(1)

CUBE_ATOL = 1e-6
CUBE_GRAD_RTOL = 1e-5
RENDER_GRAD_RTOL = 2e-3
LOSS_RTOL = 2e-4
GRAD_RTOL = 2e-3
CUBE_RES = 32
N_ITERS = 10
MLP_LEAVES = [f"{p}{i}" for i in range(4) for p in ("w", "b")]


# -- ops.cubemap ---------------------------------------------------------------

def _face_painted(rng):
    cm = np.zeros((6, 8, 8, 3), np.float32)
    for f in range(6):
        cm[f] = (f + 1) / 6.0
    dirs = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1]], np.float32)
    return cm, dirs


def _continuity(rng):
    cm = rng.uniform(size=(6, 16, 16, 3)).astype(np.float32)
    dirs = np.array([[0.5, 0.3, 1.0], [0.5001, 0.3, 1.0]], np.float32)
    return cm, dirs


def _random_dirs(rng):
    cm = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    return cm, rng.normal(size=(20, 3)).astype(np.float32)


def _ties_and_edges(rng):
    """Directions on the face-choice ties (|x| = |y|, |x| = |z|, |y| = |z|,
    all three), on cube edges and corners (u or v exactly 0 or 1, where
    the taps clamp), just inside them, and the zero direction."""
    cm = rng.uniform(size=(6, 16, 16, 3)).astype(np.float32)
    base = []
    for sx in (1, -1):
        for sy in (1, -1):
            for sz in (1, -1):
                base += [[sx, sy, 0.3 * sz], [sx, 0.3 * sy, sz],
                         [0.3 * sx, sy, sz], [sx, sy, sz]]
    near = [[1, 1 - 1e-7, 0.2], [1 - 1e-7, 1, 0.2], [0.2, 1, 1 - 1e-7],
            [1, 0.5, -1 + 1e-7], [1, 1.0 / 32, 0.0], [0.0, 1, 31.0 / 32],
            [0.0, 0.0, 0.0]]
    return cm, np.array(base + near, np.float32)


CUBE_CASES = {"face_centers": _face_painted, "continuity": _continuity,
              "random_dirs": _random_dirs, "ties_and_edges": _ties_and_edges}


@pytest.mark.parametrize("case", sorted(CUBE_CASES))
def test_sample_cubemap_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from street_crafter_tpu.ops.cubemap import sample_cubemap as j_sample
    from street_crafter_tpu_torch.ops.cubemap import sample_cubemap
    cm, dirs = CUBE_CASES[case](np.random.default_rng(0))
    want = np.asarray(j_sample(jnp.asarray(cm), jnp.asarray(dirs)))
    tc = torch.tensor(cm, requires_grad=True)
    td = torch.tensor(dirs, requires_grad=True)
    got = sample_cubemap(tc, td)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=CUBE_ATOL,
                               rtol=0)
    if case == "face_centers":
        np.testing.assert_allclose(got.detach().numpy(), np.repeat(
            (np.arange(1, 7) / 6.0)[:, None], 3, 1), atol=CUBE_ATOL)

    def loss(c, d):
        return jnp.sum(j_sample(c, d) ** 2)

    gc, gd = jax.grad(loss, argnums=(0, 1))(jnp.asarray(cm),
                                            jnp.asarray(dirs))
    (got ** 2).sum().backward()
    for g, w in ((tc.grad, gc), (td.grad, gd)):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= CUBE_GRAD_RTOL * max(np.abs(w).max(), 1e-6), (case, err)
    assert np.abs(np.asarray(gc)).sum() > 0


def test_latlong_from_cubemap_matches_jax():
    import jax.numpy as jnp

    from street_crafter_tpu.ops.cubemap import latlong_from_cubemap as j_ll
    from street_crafter_tpu_torch.ops.cubemap import latlong_from_cubemap
    cm = np.random.default_rng(0).uniform(size=(6, 8, 8, 3)).astype(
        np.float32)
    for H, W in ((16, 32), (33, 64)):
        want = np.asarray(j_ll(jnp.asarray(cm), H, W))
        got = latlong_from_cubemap(torch.tensor(cm), H, W).numpy()
        assert got.shape == (H, W, 3)
        np.testing.assert_allclose(got, want, atol=CUBE_ATOL, rtol=0)


# -- render_scene ----------------------------------------------------------------

def _cluster_scene(rng):
    """tests/test_scene_render.py:110's scene: one tight cluster, so most
    of the image is sky."""
    import jax.numpy as jnp

    from street_crafter_tpu.models.gs.params import init_pool_from_points
    from street_crafter_tpu.models.gs.scene import SceneParams
    pts = (rng.normal(size=(10, 3)) * 0.2).astype(np.float32)
    pts[:, 2] += 10
    bkgd = init_pool_from_points(pts, rng.uniform(size=(10, 3)), capacity=16,
                                 fixed_scale=0.05)
    params = SceneParams(
        bkgd=bkgd, actors=None, sky=None, opt_trans=None, opt_theta=None,
        sky_cubemap=jnp.full((6, 8, 8, 3), 0.5), color_corr=None,
        color_corr_sky=None, pose_corr_quat=None, pose_corr_trans=None)
    return params, None


def _perturbed_mlp(rng, key: int):
    """The JAX init, every leaf perturbed (the zero output layer too), so
    that every leaf has a gradient."""
    import jax

    from street_crafter_tpu.models.gs.color_mlp import init_color_mlp
    mlp = jax_tree_to_numpy(init_color_mlp(jax.random.PRNGKey(key)))
    return {k: (v + rng.normal(0, 0.05 if k in ("w3", "b3") else 0.1,
                               v.shape)).astype(np.float32)
            for k, v in mlp.items()}


def _render_case(case, rng):
    """(params, meta) as nested numpy dicts: the cluster scene with a
    random cubemap; tests/test_scene_render.py:160's scene (the toy scene
    of two actors) with the MLP; that scene with a cubemap, the MLP and the
    sky's MLP."""
    from tests.test_scene_render import make_scene as toy_scene
    if case == "cubemap":
        params, meta = _cluster_scene(rng)
    else:
        params, meta = toy_scene(rng)
    p = jax_tree_to_numpy(params)
    m = None if meta is None else jax_tree_to_numpy(meta)
    if case in ("cubemap", "cubemap_mlp"):
        p["sky_cubemap"] = rng.uniform(0.1, 0.9, (6, 8, 8, 3)).astype(
            np.float32)
    if case in ("mlp", "cubemap_mlp"):
        p["color_mlp"] = _perturbed_mlp(rng, 0)
    if case == "cubemap_mlp":
        p["color_mlp_sky"] = _perturbed_mlp(rng, 1)
    return p, m


def _c2w(yaw: float) -> np.ndarray:
    c2w = np.eye(4, dtype=np.float32)
    c, s = math.cos(yaw), math.sin(yaw)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = [0.3, -0.2, 0.5] if yaw else 0.0
    return c2w


@pytest.mark.parametrize("yaw", [0.0, 0.15])
@pytest.mark.parametrize("case", ["cubemap", "mlp", "cubemap_mlp"])
def test_render_scene_sky_and_mlp_match_jax(case, yaw):
    import jax
    import jax.numpy as jnp

    from street_crafter_tpu.datasets import Camera as JCamera
    from street_crafter_tpu.models.gs.renderer import render_scene as j_render
    from street_crafter_tpu_torch.datasets.cameras import Camera
    from street_crafter_tpu_torch.models.gs.convert import scene_from_numpy
    from street_crafter_tpu_torch.models.gs.renderer import render_scene
    p, m = _render_case(case, np.random.default_rng(0))
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    jcam = JCamera.from_c2w(_c2w(yaw), K, 64, 48)
    jp, jm = jax_scene_from_numpy(p, m)
    n = sum(int(np.prod(np.shape(p[k]["valid"]))) for k in ("bkgd", "actors")
            if p.get(k) is not None)
    kw = dict(frame_idx=1, frame=1.0, include_obj=case != "cubemap")
    leaves = [k for k in ("sky_cubemap", "color_mlp", "color_mlp_sky")
              if p.get(k) is not None]

    def j_out(sub):
        return j_render(dataclasses.replace(jp, **sub), jm, jcam,
                        method="xla", select_method="exact",
                        max_per_tile=n, max_per_coarse=n, **kw)

    ref = j_out({})
    sub0 = {k: getattr(jp, k) for k in leaves}
    gref = jax.grad(lambda s: jnp.sum(j_out(s)["rgb"] ** 2))(sub0)

    tp, tm = scene_from_numpy(p, m)
    for k in leaves:
        x = getattr(tp, k)
        for t in (x.values() if isinstance(x, dict) else [x]):
            t.requires_grad_(True)
    cam = Camera.from_extrinsic(np.asarray(jcam.w2c), K, 64, 48)
    out = render_scene(tp, tm, cam, **kw)
    acc = np.asarray(ref["acc"])
    # something rendered; where a cubemap is, the sky shows
    assert acc.max() > 0.05
    assert "sky_cubemap" not in leaves or (1 - acc).mean() > 0.2
    np.testing.assert_allclose(out["rgb"].detach().numpy(),
                               np.asarray(ref["rgb"]), atol=2e-3, rtol=0)
    np.testing.assert_allclose(out["acc"].detach().numpy(), acc, atol=2e-3,
                               rtol=0)
    for k in ("sky_rgb", "cc_mat", "cc_mat_sky"):
        assert (k in out) == (k in ref), k
        if k in ref:
            np.testing.assert_allclose(out[k].detach().numpy(),
                                       np.asarray(ref[k]), atol=1e-6, rtol=0)
    (out["rgb"] ** 2).sum().backward()
    for k in leaves:
        x, want = getattr(tp, k), gref[k]
        pairs = ([(x[s].grad, want[s], f"{k}.{s}") for s in MLP_LEAVES]
                 if isinstance(x, dict) else [(x.grad, want, k)])
        for g, w, name in pairs:
            w = np.asarray(w)
            if name.startswith("color_mlp_sky"):
                # only the regulariser reads the sky's affine
                assert g is None and not w.any(), name
                continue
            err = np.abs(g.numpy() - w).max()
            assert err <= RENDER_GRAD_RTOL * np.abs(w).max(), (name, err)


# -- GS training -----------------------------------------------------------------

def sky_color_config(cfg):
    """The training slice's settings (tests/test_torch_train.py) with the
    cubemap sky, the MLP colour correction with its sky MLP, and the
    colour regulariser on (it alone reads the sky's MLP)."""
    from tests.test_torch_train import slice_config
    slice_config(cfg)
    cfg.model.sky.use_cube_map = True
    cfg.model.sky.resolution = CUBE_RES
    cfg.model.use_color_correction = True
    cfg.model.color_correction.use_mlp = True
    cfg.model.color_correction.use_sky = True
    cfg.optim.lambda_color_correction = 0.1
    cfg.model.gaussian.flip_prob = 0.0
    return cfg


@pytest.fixture(scope="module")
def jax_sky_color(tmp_path_factory):
    """The JAX package's scene with cubemap + MLP + sky MLP, its train
    state with the texture and every MLP leaf perturbed, and one JAX step."""
    import jax
    import jax.numpy as jnp

    from street_crafter_tpu.config import default_config
    from street_crafter_tpu.ops.lpips import lpips_distance, \
        random_lpips_params
    from street_crafter_tpu.runner import create_scene
    from street_crafter_tpu.training.gs_trainer import (init_train_state,
                                                        make_train_step)
    from street_crafter_tpu_torch.utils.png import read_png, write_png
    root = tmp_path_factory.mktemp("torch_sky_color")
    cfg = sky_color_config(default_config())
    cfg.source_path = make_scene(str(root), num_frames=3)
    # no gt value of exactly 0, where a render clamped at 0 ties with it:
    # d|x|/dx at 0 is 1 in JAX and 0 in torch (ROADMAP queue 3)
    img_dir = os.path.join(cfg.source_path, "images")
    for name in os.listdir(img_dir):
        path = os.path.join(img_dir, name)
        write_png(path, np.maximum(read_png(path), 1))
    cfg.model_path = str(root / "model")
    scene = create_scene(cfg)
    assert scene.params.sky is None and scene.params.sky_cubemap.shape == (
        6, CUBE_RES, CUBE_RES, 3)
    n = sum(int(np.prod(p.valid.shape)) for p in
            (scene.params.bkgd, scene.params.actors))
    cfg.render.train_method = "xla"
    cfg.render.train_auto_capacity = False
    cfg.render.max_intersects_per_tile = n
    cfg.render.max_intersects_per_coarse = n
    lp = {k: np.asarray(v) for k, v in
          random_lpips_params(jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(0)

    def jittered(pool, **scales):
        return pool.replace(**{k: getattr(pool, k) + jnp.asarray(rng.normal(
            0, sd, getattr(pool, k).shape), jnp.float32)
            for k, sd in scales.items()})

    params = dataclasses.replace(
        scene.params,
        bkgd=jittered(scene.params.bkgd, features_dc=1e-4),
        actors=jittered(scene.params.actors, xyz=1e-3, features_dc=1e-4),
        sky_cubemap=jnp.asarray(rng.uniform(
            0.2, 0.8, scene.params.sky_cubemap.shape).astype(np.float32)),
        color_mlp={k: jnp.asarray(v)
                   for k, v in _perturbed_mlp(rng, 0).items()},
        color_mlp_sky={k: jnp.asarray(v)
                       for k, v in _perturbed_mlp(rng, 1).items()})
    state0 = init_train_state(params)
    step = make_train_step(cfg, scene.meta, spatial_lr_scale=scene.extent,
                           lpips_fn=lambda a, b: lpips_distance(lp, a, b),
                           active_sh_degree=1)
    info, cam = scene.info.train_cameras[1], scene.train_cameras[1]
    batch = scene.batch_for(info)
    state1, scalars = step(state0, cam, batch, jax.random.PRNGKey(0))
    return dict(cfg=cfg, scene=scene, lp=lp, n=n, params=params,
                before=jax_tree_to_numpy(state0),
                after=jax_tree_to_numpy(state1),
                scalars={k: float(v) for k, v in scalars.items()},
                cam=cam, batch=batch)


def _misc_names():
    return (["sky_cubemap"] + [f"color_mlp.{s}" for s in MLP_LEAVES]
            + [f"color_mlp_sky.{s}" for s in MLP_LEAVES])


def test_train_state_carries_sky_and_mlp_leaves(jax_sky_color, tmp_path):
    from street_crafter_tpu_torch.models.gs.convert import (
        train_state_from_dict, train_state_to_numpy)
    from street_crafter_tpu_torch.utils.checkpoint import (
        load_train_checkpoint, save_checkpoint)
    before = jax_sky_color["before"]
    assert sorted(before["adam_misc"]["m"]) == sorted(
        _misc_names() + ["opt_theta", "opt_trans"])
    assert before["params"]["sky"] is None
    state = train_state_from_dict(before)
    assert state.adam_sky is None and state.dstate_sky is None
    assert state.params.color_mlp["w0"].requires_grad
    save_checkpoint(str(tmp_path), 5, state.params, state)
    restored, it = load_train_checkpoint(str(tmp_path))
    assert it == 5
    for got in (train_state_to_numpy(state), train_state_to_numpy(restored)):
        for k in ("sky_cubemap", "color_mlp", "color_mlp_sky"):
            want = before["params"][k]
            if isinstance(want, dict):
                for s in MLP_LEAVES:
                    np.testing.assert_array_equal(got["params"][k][s],
                                                  want[s])
            else:
                np.testing.assert_array_equal(got["params"][k], want)
        for name in _misc_names():
            for mv in ("m", "v"):
                np.testing.assert_array_equal(
                    got["adam_misc"][mv][name], before["adam_misc"][mv][name])


def test_train_step_sky_and_mlp_match_jax(jax_sky_color):
    """Loss terms and the gradients of the texture and of every MLP leaf
    (as the first Adam moment m = 0.1 g of the step)."""
    from street_crafter_tpu_torch.datasets.cameras import Camera
    from street_crafter_tpu_torch.models.gs.convert import (
        meta_from_dict, train_state_from_dict, train_state_to_numpy)
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.ops.lpips import lpips_distance
    from street_crafter_tpu_torch.training.gs_trainer import make_train_step
    s = jax_sky_color
    state = train_state_from_dict(s["before"])
    meta = meta_from_dict(jax_tree_to_numpy(s["scene"].meta))
    jcam = s["cam"]
    cam = Camera.from_extrinsic(np.asarray(jcam.w2c), np.asarray(jcam.K),
                                jcam.width, jcam.height)
    batch = {k: (torch.tensor(np.asarray(v)) if k in (
        "gt_image", "mask", "sky_mask", "obj_bound", "lidar_depth")
        else (float(v) if k in ("frame", "timestamp") else int(v)))
        for k, v in s["batch"].items()}
    step = make_train_step(s["cfg"], meta,
                           spatial_lr_scale=s["scene"].extent,
                           lpips_fn=lambda a, b: lpips_distance(s["lp"], a, b),
                           active_sh_degree=1)
    G.reset_launch_counts()
    _, scalars = step(state, cam, batch)
    # one rasterization a step: the cubemap replaces the sky pass
    assert G.launches["tile_worklist_reference"] == 1
    assert G.launches["composite_backward_reference"] == 1
    assert sorted(scalars) == sorted(s["scalars"])
    assert s["scalars"]["color_correction_loss"] > 0
    for k, want in s["scalars"].items():
        assert float(scalars[k]) == pytest.approx(want, rel=LOSS_RTOL), k
    got, want = train_state_to_numpy(state), s["after"]
    for name in _misc_names():
        g, w = got["adam_misc"]["m"][name], want["adam_misc"]["m"][name]
        assert np.abs(w).max() > 0, name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < GRAD_RTOL, (name, err)


def test_losses_over_n_iterations_match_jax(jax_sky_color, tmp_path):
    """The JAX and the port trainer loops from the JAX train state: the
    same camera sequence, per-iteration losses within LOSS_RTOL."""
    from street_crafter_tpu.runner.train import GSTrainer as JTrainer
    from street_crafter_tpu.ops.lpips import lpips_distance as j_lpips
    from street_crafter_tpu.training.gs_trainer import init_train_state
    from street_crafter_tpu_torch.config import default_config as p_default
    from street_crafter_tpu_torch.models.gs.convert import (
        meta_from_dict, train_state_from_dict)
    from street_crafter_tpu_torch.ops.lpips import lpips_distance as p_lpips
    from street_crafter_tpu_torch.runner import create_scene as p_scene
    from street_crafter_tpu_torch.runner.train import GSTrainer as PTrainer
    s = jax_sky_color
    lp = s["lp"]

    def loop(cfg, model_path):
        cfg.model_path = model_path
        cfg.seed = 3
        cfg.optim.densify_from_iter = 10 ** 6
        cfg.optim.opacity_reset_interval = 10 ** 6
        t = cfg.train
        t.iterations, t.test_iterations = N_ITERS, []
        t.checkpoint_iterations, t.log_interval = [], 1
        cfg.diffusion.use_diffusion = False
        return cfg

    jcfg = loop(s["cfg"].clone(), str(tmp_path / "jax"))
    jtrainer = JTrainer(jcfg, s["scene"],
                        lpips_fn=lambda a, b: j_lpips(lp, a, b))
    jtrainer.state = init_train_state(s["params"])
    start = jax_tree_to_numpy(jtrainer.state)

    pcfg = loop(sky_color_config(p_default()), str(tmp_path / "port"))
    pcfg.source_path = s["cfg"].source_path
    pcfg.device = "cpu"
    pscene = p_scene(pcfg)
    pscene.meta = meta_from_dict(jax_tree_to_numpy(s["scene"].meta))
    ptrainer = PTrainer(pcfg, pscene, lpips_fn=lambda a, b: p_lpips(lp, a, b))
    ptrainer.state = train_state_from_dict(start)

    losses = {"jax": [], "port": []}
    for name, trainer in (("jax", jtrainer), ("port", ptrainer)):
        trainer.run(log_fn=lambda it, vals, name=name:
                    losses[name].append(vals["loss"]))
    got, want = np.array(losses["port"]), np.array(losses["jax"])
    assert got.shape == want.shape == (N_ITERS,)
    drift = np.abs(got - want) / np.abs(want)
    print("per-iteration relative loss drift:",
          json.dumps([float(f"{d:.3g}") for d in drift]))
    assert drift.max() <= LOSS_RTOL, drift
    # the texture and every MLP leaf moved
    p0 = train_state_from_dict(start).params
    p1 = ptrainer.state.params
    assert not torch.equal(p0.sky_cubemap, p1.sky_cubemap.detach())
    for k in ("color_mlp", "color_mlp_sky"):
        for sub in MLP_LEAVES:
            assert not torch.equal(getattr(p0, k)[sub],
                                   getattr(p1, k)[sub].detach()), (k, sub)


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    """runner.train.main on the port's synthetic scene with the cubemap,
    the MLP, its sky MLP and COLMAP points (a text model written with the
    port's ``write_text_model``), 8 iterations, checkpoint and PLY at 8,
    then 2 more resumed."""
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.datasets.synthetic import make_scene as pm
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.runner.train import main
    from street_crafter_tpu_torch.utils.colmap_io import write_text_model
    root = tmp_path_factory.mktemp("torch_sky_color_main")
    cfg = sky_color_config(default_config())
    cfg.device = "cpu"
    cfg.source_path = pm(str(root), num_frames=3)
    cfg.model_path = str(root / "model")
    cfg.data.use_colmap = True
    cfg.diffusion.use_diffusion = False
    cfg.optim.densify_from_iter = 10 ** 6
    cfg.optim.opacity_reset_interval = 10 ** 6
    t = cfg.train
    t.iterations, t.test_iterations = 8, [8]
    t.checkpoint_iterations, t.save_iterations = [8], [8]
    t.log_interval = 1
    rng = np.random.default_rng(5)
    colmap = (rng.uniform([0, -8, 0], [20, 8, 4], (300, 3)),
              rng.integers(0, 256, (300, 3)).astype(np.uint8),
              rng.uniform(0, 1, 300))
    write_text_model(os.path.join(cfg.model_path, "colmap", "triangulated",
                                  "sparse", "model"), {}, {}, points=colmap)
    path = str(root / "scene.json")
    save_config(cfg, path)
    G.reset_launch_counts()
    trainer = main(["--config", path])
    counts = dict(G.launches)
    with open(os.path.join(cfg.model_path, "logs", "metrics.jsonl")) as f:
        losses = [json.loads(x)["train/loss"] for x in f
                  if "train/loss" in x]
    resumed = main(["--config", path, "train.iterations=10"])
    return dict(cfg=cfg, trainer=trainer, counts=counts, losses=losses,
                resumed=resumed, colmap=colmap)


def test_train_main_with_the_slice_features(port_trained):
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.ply import read_ply
    from street_crafter_tpu_torch.utils.png import read_png
    cfg, trainer = port_trained["cfg"], port_trained["trainer"]
    assert len(port_trained["losses"]) == 8
    assert np.isfinite(port_trained["losses"]).all()
    # one rasterization a step (no sky pass), besides the train and test
    # views' condition renders (lambda_depth_lidar > 0), the eval's renders
    # and its logged image
    counts = port_trained["counts"]
    info = trainer.scene.info
    n_cond = len(info.train_cameras) + len(info.test_cameras)
    assert counts["composite_backward_reference"] == 8
    assert counts["tile_worklist_reference"] == (
        8 + n_cond + len(info.test_cameras) + 1)
    init = create_scene(cfg).params
    p = trainer.state.params
    assert p.sky is None and trainer.state.adam_sky is None
    assert not torch.equal(init.sky_cubemap, p.sky_cubemap.detach())
    for k in ("color_mlp", "color_mlp_sky"):
        assert sorted(getattr(p, k)) == sorted(MLP_LEAVES)
    # the output layers move from their zero init at the first step
    assert p.color_mlp["w3"].abs().max() > 0
    ll = read_png(os.path.join(cfg.model_path, "point_cloud", "iteration_8",
                               "sky_latlong.png"))
    assert ll.shape == (512, 1024, 3) and ll.std() > 0
    # the COLMAP points joined the background's init
    xyz = port_trained["colmap"][0]
    ply = os.path.join(cfg.model_path, "input_ply")
    col = read_ply(os.path.join(ply, "points3D_colmap.ply")).points
    np.testing.assert_allclose(col, xyz.astype(np.float32))
    bkgd = read_ply(os.path.join(ply, "points3D_bkgd.ply")).points
    lidar = read_ply(os.path.join(ply, "points3D_lidar.ply")).points
    assert len(lidar) < len(bkgd) <= len(lidar) + len(xyz)
    resumed = port_trained["resumed"]
    assert resumed.start_iter == 9 and resumed.state.step == 10
    assert int(resumed.state.adam_misc.count) == 10

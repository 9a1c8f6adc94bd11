"""Port parity and end to end for the training slice of
street_crafter_tpu_torch: one train step against the JAX package's step
(XLA raster on the CPU, capacities >= N, no flips) from a converted train
state, the train-state conversion both ways, the trainer through
``runner.train.main`` (densify, opacity reset, eval, checkpoint, resume,
PLY export) and a render of its checkpoint, and the no-jax import contract.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.torch_port_helpers import jax_tree_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOLS = ("bkgd", "actors", "sky")


def slice_config(cfg):
    """configs/waymo_val_base.yaml's GS settings at test size."""
    cfg.data.cameras = [0, 1]
    cfg.data.split_test = 2
    cfg.optim.capacity_bkgd = 1024
    cfg.optim.capacity_obj = 128
    cfg.optim.capacity_sky = 512
    cfg.render.novel_view.shift = [2.0]
    cfg.model.gaussian.sh_degree = 1
    cfg.model.nsg.opt_track = True
    o = cfg.optim
    o.densify_grad_threshold = 0.0006
    o.densify_grad_abs_bkgd = True
    o.densify_grad_abs_obj = True
    o.lambda_dssim = 0.2
    o.lambda_reg = 0.1
    o.lambda_sky = 0.05
    o.lambda_depth_lidar = 0.01
    o.lambda_lpips = 0.5
    o.lpips_fallback = "random_features"
    return cfg


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """The JAX package's scene, initial train state and one train step."""
    import jax
    import jax.numpy as jnp

    from street_crafter_tpu.config import default_config
    from street_crafter_tpu.models.gs import losses as jl
    from street_crafter_tpu.models.gs.renderer import render_scene
    from street_crafter_tpu.ops.lpips import lpips_distance, \
        random_lpips_params
    from street_crafter_tpu.runner import create_scene
    from street_crafter_tpu.training.gs_trainer import (init_train_state,
                                                        make_train_step)
    root = tmp_path_factory.mktemp("torch_train_jax")
    cfg = slice_config(default_config())
    cfg.source_path = make_scene(str(root), num_frames=3)
    cfg.model_path = str(root / "model")
    cfg.model.gaussian.flip_prob = 0.0
    scene = create_scene(cfg)
    n = sum(int(np.prod(p.valid.shape)) for p in
            (scene.params.bkgd, scene.params.actors, scene.params.sky))
    cfg.render.train_method = "xla"
    cfg.render.max_intersects_per_tile = n
    cfg.render.max_intersects_per_coarse = n
    lp = {k: np.asarray(v) for k, v in
          random_lpips_params(jax.random.PRNGKey(0)).items()}
    lpips_fn = lambda a, b: lpips_distance(lp, a, b)  # noqa: E731
    # the grid-initialised actor stacks splats at equal depth, whose order
    # the port's stable sort and JAX's top_k break differently: jitter it
    # and SH DC colours that clamp at exactly 0 (max(c + 0.5, 0)), where
    # jnp.maximum passes half the gradient and torch.clamp all of it
    rng = np.random.default_rng(0)

    def jittered(pool, **scales):
        return pool.replace(**{k: getattr(pool, k) + jnp.asarray(rng.normal(
            0, sd, getattr(pool, k).shape), jnp.float32)
            for k, sd in scales.items()})

    params = dataclasses.replace(
        scene.params,
        bkgd=jittered(scene.params.bkgd, features_dc=1e-4),
        actors=jittered(scene.params.actors, xyz=1e-3, features_dc=1e-4),
        sky=jittered(scene.params.sky, features_dc=1e-4))
    state0 = init_train_state(params)
    before = jax_tree_to_numpy(state0)
    step = make_train_step(cfg, scene.meta, spatial_lr_scale=scene.extent,
                           lpips_fn=lpips_fn, active_sh_degree=1)
    info, cam = scene.info.train_cameras[1], scene.train_cameras[1]
    # no pixel of the image equal to the render (whose SH colours clamp at
    # exactly 0): d|x|/dx at x = 0 is 1 in JAX and 0 in torch (ROADMAP
    # queue 3)
    batch = dict(scene.batch_for(info))
    batch["gt_image"] = jnp.clip(batch["gt_image"], 1e-3, 1.0)
    state1, scalars = step(state0, cam, batch, jax.random.PRNGKey(0))

    # the sky pass's per-splat screen gradients, by JAX autodiff of the
    # same loss: the JAX step's sky statistics take jnp.linalg.norm(x, -1),
    # whose -1 is the matrix norm's ord, not an axis (ROADMAP queue 3)
    weights = jl.LossWeights(**{f: float(cfg.optim[f])
                                for f in jl.LossWeights._fields})

    def sky_loss(vz, sink):
        out = render_scene(
            params, scene.meta, cam, frame_idx=batch["frame_idx"],
            frame=batch["frame"], cam_id=batch["cam_id"],
            timestamp=batch.get("timestamp"), image_idx=batch["image_idx"],
            sh_degree=1, max_per_tile=n, max_per_coarse=n,
            viewspace_zero_sky=vz, absgrad_sink_sky=sink, method="xla")
        loss, _ = jl.compute_train_loss(
            out, batch, weights, lpips_fn=lpips_fn,
            scene_scaling=params.bkgd.get_scaling(),
            scene_valid=params.bkgd.valid)
        return loss, out["visibility_sky"]

    z = jnp.zeros((params.sky.capacity, 2), jnp.float32)
    (gvz, gabs), vis = jax.jit(jax.grad(sky_loss, argnums=(0, 1),
                                        has_aux=True))(z, z)
    scale = 0.5 * np.array([cam.width, cam.height], np.float32)
    sky_stats = {k: np.linalg.norm(np.asarray(g) * scale, axis=-1)
                 * np.asarray(vis) for k, g in (("grad_accum", gvz),
                                                ("grad_abs_accum", gabs))}
    return dict(cfg=cfg, scene=scene, lpips=lp, before=before,
                after=jax_tree_to_numpy(state1),
                scalars={k: float(v) for k, v in scalars.items()},
                info=info, cam=cam, batch=batch, sky_stats=sky_stats)


def test_train_state_conversion_round_trip(jax_setup):
    from street_crafter_tpu_torch.models.gs.convert import (
        train_state_from_dict, train_state_to_numpy)
    before = jax_setup["before"]
    state = train_state_from_dict(before)
    back = train_state_to_numpy(state)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif a is None:
            assert b is None, path
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=path)
    walk(before, back)
    assert state.params.bkgd.xyz.requires_grad


def test_train_step_matches_jax(jax_setup):
    """Loss terms, the gradients (as the first Adam moment m = 0.1 g of
    the step), the densification statistics and the updated parameters."""
    from street_crafter_tpu_torch.datasets.cameras import Camera
    from street_crafter_tpu_torch.models.gs.convert import (
        meta_from_dict, train_state_from_dict, train_state_to_numpy)
    from street_crafter_tpu_torch.ops.lpips import lpips_distance
    from street_crafter_tpu_torch.training.gs_trainer import make_train_step
    s = jax_setup
    cfg = s["cfg"]
    scene = s["scene"]
    state = train_state_from_dict(s["before"])
    meta = meta_from_dict(jax_tree_to_numpy(scene.meta))
    jcam = s["cam"]
    cam = Camera.from_extrinsic(np.asarray(jcam.w2c), np.asarray(jcam.K),
                                jcam.width, jcam.height)
    batch = {k: (torch.tensor(np.asarray(v)) if k in (
        "gt_image", "mask", "sky_mask", "obj_bound", "lidar_depth")
        else (float(v) if k in ("frame", "timestamp") else int(v)))
        for k, v in s["batch"].items()}
    step = make_train_step(cfg, meta, spatial_lr_scale=scene.extent,
                           lpips_fn=lambda a, b: lpips_distance(
                               s["lpips"], a, b), active_sh_degree=1)
    _, scalars = step(state, cam, batch)
    assert sorted(scalars) == sorted(s["scalars"])
    for k, want in s["scalars"].items():
        # LPIPS's conv stack agrees to 1e-4 (test_torch_train_ops.py); the
        # rest is the same loss on renders equal to ~1e-6
        assert float(scalars[k]) == pytest.approx(want, rel=2e-4), k
    got, want = train_state_to_numpy(state), s["after"]
    assert got["step"] == int(want["step"]) == 1

    def rel(a, b):
        return np.abs(a - b).max() / (np.abs(b).max() + 1e-20)

    for group in ("adam_bkgd", "adam_actors", "adam_sky", "adam_misc"):
        top = max(np.abs(m).max() for m in want[group]["m"].values())
        for k, m in want[group]["m"].items():
            g = got[group]["m"][k]
            if k == "rotation":
                # the scene-init splats are isotropic, so their rotation
                # gradient is zero up to rounding: held against the pool's
                # largest gradient instead of its own
                assert np.abs(g - m).max() < 2e-3 * top, (group, k)
                continue
            # gradients through projection, SH and compositing of ~1.7k
            # splats: f32 sums in another order, and a (pixel, splat) pair
            # on the 1/255 gate to the ulp can flip
            assert rel(g, m) < 2e-3, (group, k)
            assert rel(got[group]["v"][k], want[group]["v"][k]) < 4e-3, \
                (group, k)
    for pool in ("bkgd", "actors", "sky"):
        d, w = got[f"dstate_{pool}"], want[f"dstate_{pool}"]
        np.testing.assert_array_equal(d["denom"], w["denom"])
        np.testing.assert_array_equal(d["max_radii2d"], w["max_radii2d"])
        if pool == "sky":
            # JAX's step adds one scalar to every visible sky splat
            assert len(np.unique(w["grad_accum"][w["denom"] > 0])) == 1
            w = s["sky_stats"]
        for k in ("grad_accum", "grad_abs_accum"):
            assert rel(d[k], w[k]) < 2e-3, (pool, k)
        assert w["grad_abs_accum"].max() > 0
        for k in ("xyz", "opacity", "scaling"):
            # one Adam step moves each by ~lr sign(g): equal up to the
            # signs of gradients that are zero to rounding
            a = got["params"][pool][k]
            b = want["params"][pool][k]
            assert np.mean(np.isclose(a, b, rtol=1e-5, atol=1e-7)) > 0.99


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """runner.train.main on the port's synthetic scene, 24 iterations:
    densify at 8 and 16, an opacity reset at 12, eval, checkpoint and PLY
    at 24; then 3 more iterations resumed from that checkpoint."""
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.datasets.synthetic import make_scene as pm
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.runner.train import main
    root = tmp_path_factory.mktemp("torch_train_port")
    cfg = slice_config(default_config())
    cfg.device = "cpu"
    cfg.source_path = pm(str(root), num_frames=3)
    cfg.model_path = str(root / "model")
    cfg.model.gaussian.flip_prob = 0.2
    o = cfg.optim
    o.densify_from_iter, o.densification_interval = 8, 8
    o.densify_until_iter, o.opacity_reset_interval = 16, 12
    cfg.train.iterations = 24
    cfg.train.test_iterations = [24]
    cfg.train.checkpoint_iterations = [24]
    cfg.train.save_iterations = [24]
    cfg.train.log_interval = 4
    cfg.profiler.enabled = True
    cfg.profiler.start_iter, cfg.profiler.num_iters = 2, 2
    path = str(root / "scene.json")
    save_config(cfg, path)
    init = create_scene(cfg).params
    G.reset_launch_counts()
    trainer = main(["--config", path])
    counts = dict(G.launches)
    resumed = main(["--config", path, "train.iterations=27"])
    return dict(cfg=cfg, path=path, init=init, trainer=trainer,
                counts=counts, resumed=resumed)


def test_trainer_end_to_end(trained):
    from street_crafter_tpu_torch.utils.checkpoint import checkpoint_dir
    cfg, trainer = trained["cfg"], trained["trainer"]
    state = trainer.state
    assert state.step == 24
    # densify changed the pools (the background pool starts full: its
    # children need the slots that pruning frees)
    assert (sum(getattr(state.params, p).num_valid() for p in POOLS)
            != sum(getattr(trained["init"], p).num_valid() for p in POOLS))
    counts = trained["counts"]
    assert counts["composite_backward_reference"] >= 2 * 24   # fg + sky
    assert "composite_backward" not in counts   # CPU: no kernel
    lines = open(os.path.join(cfg.model_path, "logs",
                              "metrics.jsonl")).read().splitlines()
    # 6 train logs and the eval, then the resumed run's log at 27
    assert len(lines) == 24 // 4 + 2
    assert '"eval/psnr"' in lines[6] and '"eval/n_pairs"' in lines[6]
    assert lines[7].startswith('{"step": 27')
    assert os.listdir(os.path.join(cfg.model_path, "logs", "images"))
    ck = checkpoint_dir(cfg.model_path, 24)
    assert sorted(os.listdir(ck)) == ["params.pt", "train_state.pt"]
    assert os.path.exists(os.path.join(cfg.model_path, "config.json"))
    assert os.path.getsize(os.path.join(cfg.model_path, "traces",
                                        "trace.json")) > 0
    assert os.path.isdir(os.path.join(cfg.model_path, "code_backup",
                                      "street_crafter_tpu_torch"))
    resumed = trained["resumed"]
    assert resumed.start_iter == 25 and resumed.state.step == 27
    # the resumed state carried the moments and counts across
    assert int(resumed.state.adam_bkgd.count) == 27


def test_ply_export_round_trip(trained):
    from street_crafter_tpu.utils.gs_ply import import_gaussians_ply as j_imp
    from street_crafter_tpu_torch.utils.gs_ply import (export_gaussians_ply,
                                                       import_gaussians_ply)
    cfg, trainer = trained["cfg"], trained["trainer"]
    path = os.path.join(cfg.model_path, "point_cloud", "iteration_24",
                        "point_cloud.ply")
    params = trainer.state.params
    pools = import_gaussians_ply(path)
    assert sorted(pools) == ["bkgd", "obj_000", "sky"]
    jpools = j_imp(path)          # the JAX package reads the port's file
    for name, src in (("bkgd", params.bkgd), ("sky", params.sky)):
        v = src.valid
        for f in ("xyz", "features_dc", "features_rest", "scaling",
                  "rotation", "opacity"):
            want = getattr(src, f).detach()[v].numpy()
            np.testing.assert_array_equal(getattr(pools[name], f).numpy(),
                                          want)
            np.testing.assert_array_equal(np.asarray(getattr(jpools[name],
                                                             f)), want)
    # a pool padded to a capacity, and a single-pool file
    padded = import_gaussians_ply(path, capacity=4096)["bkgd"]
    assert padded.capacity == 4096
    assert padded.num_valid() == params.bkgd.num_valid()
    single = os.path.join(os.path.dirname(path), "single.ply")
    export_gaussians_ply(single, padded)
    assert list(import_gaussians_ply(single)) == ["vertex"]


def test_render_of_trained_checkpoint(trained):
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.runner.render import main
    G.reset_launch_counts()
    res = main(["--config", trained["path"], "mode=trajectory",
                "render.save_video=false"])
    assert res["out_dir"].endswith("trajectory_27")
    assert np.isfinite(res["psnr"])
    # eval renders take the forward-only path: no backward, no graph
    assert "composite_backward_reference" not in G.launches


def test_unported_options_raise(trained):
    from street_crafter_tpu_torch.runner.train import main
    path = trained["path"]
    # camera batches run (tests/test_torch_gs_dp.py) and a frames axis
    # replicates them (tests/test_torch_frames_sp.py); one process has no
    # second rank for it
    with pytest.raises(ValueError, match="not divisible"):
        main(["--config", path, "train.batch_size=2", "mesh.axes.frames=2"])
    with pytest.raises(RuntimeError, match="LPIPS"):
        main(["--config", path, "optim.lpips_fallback=none",
              "model_path=" + trained["cfg"].model_path + "_x"])


def test_train_modules_import_no_jax():
    code = """
import sys
from street_crafter_tpu_torch.runner import train  # noqa: F401
from street_crafter_tpu_torch.training import gs_trainer  # noqa: F401
from street_crafter_tpu_torch.utils import gs_ply, metrics  # noqa: F401
from street_crafter_tpu_torch.runner import diffusion, render  # noqa: F401
from street_crafter_tpu_torch.ops import point_raster  # noqa: F401
from street_crafter_tpu_torch.data_processor import (  # noqa: F401
    pointcloud, render_lidar, colmap_driver, colmap_convert)
from street_crafter_tpu_torch.ops import cubemap, warp  # noqa: F401
from street_crafter_tpu_torch.models.gs import color_mlp  # noqa: F401
from street_crafter_tpu_torch.utils import colmap_io  # noqa: F401
from street_crafter_tpu_torch.visualizers import compare  # noqa: F401
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "street_crafter_tpu"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

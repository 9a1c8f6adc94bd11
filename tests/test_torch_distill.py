"""The port's distillation loop (street_crafter_tpu_torch.runner.train with
the diffusion hook, and runner.render's ``diffusion`` mode) on the CPU.

- ``runner.train.main`` with the tiny engine (the loop of
  tests/test_distillation_e2e.py: 8 iterations, an event at 3): novel
  images at the diffusion size, the diffusion PNGs, steps advanced; then
  ``runner.render.main(mode=diffusion)`` on the checkpoint, and a resume
  from the checkpoint at 6 with events at 3 and 6, which runs the event of
  6 again at 7 (novel images are not checkpointed).
- The SDS scale schedule and the resume re-run against the JAX trainer's
  own loop, for several (sample_iterations, sds_scales, start_iter): both
  loops driven over a stand-in scene whose batches have no image, so that
  only the schedule runs.
- ``diffusion.masked_guidance_iter`` below and above the event gives
  bit-equal novel images: masked guidance has no effect (the reference
  comments its consumption out; the JAX runner drops the flag).
- Losses over N iterations: the JAX and port loops from the same JAX train
  state on the tiny scene, with one event that attaches the same numpy
  novel images in both (a stand-in hook), flips and densify off: the same
  camera sequence (train or novel, and which), and per-iteration losses
  within LOSS_RTOL (tests/test_torch_train.py's one-step 2e-4 relative,
  held over the run).
"""

import dataclasses
import json
import os
import random
import shutil
import types

import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.torch_port_helpers import jax_tree_to_numpy

torch.set_num_threads(1)

DH, DW = 32, 64       # diffusion size (the tiny engine's)
LOSS_RTOL = 2e-4


def distill_config(cfg, root: str, scene_dir: str):
    """tests/test_distillation_e2e.py's loop, on the CPU."""
    cfg.device = "cpu"
    cfg.source_path = scene_dir
    cfg.model_path = os.path.join(root, "model")
    cfg.data.cameras = [0]
    cfg.data.split_test = 2
    cfg.train.iterations = 8
    cfg.train.test_iterations = []
    cfg.train.checkpoint_iterations = [6]
    cfg.train.novel_view_prob = 0.9
    cfg.train.log_interval = 1000
    cfg.optim.capacity_bkgd = 2048
    cfg.optim.capacity_obj = 256
    cfg.optim.capacity_sky = 512
    cfg.optim.densify_from_iter = 1000
    cfg.optim.opacity_reset_interval = 100000
    cfg.render.novel_view.shift = [2.0]
    cfg.render.save_video = False
    cfg.model.gaussian.sh_degree = 1
    cfg.optim.allow_missing_lpips = True
    d = cfg.diffusion
    d.use_diffusion = True
    d.tiny = True
    d.height, d.width = DH, DW
    d.sample_frames = 4
    d.window_size = 1
    d.num_steps = 3
    d.sample_iterations = [3]
    d.sds_scales = [0.7]
    d.masked_guidance_iter = 10000
    return cfg


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.datasets.synthetic import make_scene as pm
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.runner import train as T
    root = str(tmp_path_factory.mktemp("torch_distill"))
    cfg = distill_config(default_config(), root, pm(root, num_frames=3))
    path = os.path.join(root, "cfg.json")
    save_config(cfg, path)
    events = []
    hook = T.make_diffusion_hook

    def counting_hook(c, *mesh):
        h = hook(c, *mesh)

        def wrapped(trainer, iteration, scale):
            events.append((iteration, scale))
            h(trainer, iteration, scale)
        wrapped.param_store = h.param_store
        return wrapped

    T.make_diffusion_hook = counting_hook
    try:
        G.reset_launch_counts()
        trainer = T.main(["--config", path])
        counts = dict(G.launches)
        first = list(events)
        from street_crafter_tpu_torch.runner.render import main as render
        rendered = render(["--config", path, "mode=diffusion"])
        from street_crafter_tpu_torch.utils.checkpoint import checkpoint_dir
        shutil.rmtree(checkpoint_dir(cfg.model_path, 8))
        events.clear()
        resumed = T.main(["--config", path, "resume=true",
                          "diffusion.sample_iterations=[3,6]",
                          "diffusion.sds_scales=[0.7,0.3]"])
    finally:
        T.make_diffusion_hook = hook
    return dict(cfg=cfg, trainer=trainer, counts=counts, events=first,
                rendered=rendered, resumed=resumed, resume_events=events)


def test_distillation_loop(distilled):
    cfg, trainer = distilled["cfg"], distilled["trainer"]
    assert distilled["events"] == [(3, 0.7)]
    novel = trainer.scene.info.novel_view_cameras
    assert len(novel) == 3     # 3 frames x 1 shift, front camera
    for c in novel:
        assert c._image.shape == (DH, DW, 3)
        assert np.isfinite(c._image).all()
        assert c.metadata["diffusion_version"] == 1
        # the batch carries the sample at the diffusion size
        assert tuple(trainer.scene.batch_for(c)["gt_image"].shape) == (
            DH, DW, 3)
    saved = set(os.listdir(os.path.join(cfg.model_path, "diffusion")))
    assert {f"{c.image_name}_scale0.7.png" for c in novel} <= saved
    assert trainer.state.step == 8
    # the condition PNGs of the train and test views were written first
    for c in trainer.scene.info.train_cameras + \
            trainer.scene.info.test_cameras:
        assert os.path.exists(c.metadata["guidance_mask_path"])
    # the SDS renders and the steps ran the plain raster on the CPU
    assert distilled["counts"]["composite_backward_reference"] >= 2 * 8
    assert "composite" not in distilled["counts"]


def test_render_diffusion_mode(distilled):
    res = distilled["rendered"]
    assert res["out_dir"].endswith("diffusion_8")
    assert len(res["frames"]) == 3 and res["videos"] == {}
    from street_crafter_tpu_torch.utils.png import read_png
    assert read_png(res["frames"][0]).shape == (DH, DW, 3)


def test_resume_reruns_the_event(distilled):
    resumed = distilled["resumed"]
    assert resumed.start_iter == 7 and resumed.state.step == 8
    # the event of 6 again at 7, at 6's scale (the smallest)
    assert distilled["resume_events"] == [(7, pytest.approx(0.3))]
    novel = resumed.scene.info.novel_view_cameras
    assert all(c.metadata["diffusion_version"] == 1 for c in novel)
    saved = set(os.listdir(os.path.join(distilled["cfg"].model_path,
                                        "diffusion")))
    assert {f"{c.image_name}_scale0.3.png" for c in novel} <= saved


# ------------------------------------------------------------ schedule


def _stand_in_scene(tmp):
    """Train-camera stand-ins whose batches lack an image: both loops run
    their schedule and skip every step."""
    infos = [types.SimpleNamespace(uid=i, metadata={}, image_name=str(i))
             for i in range(3)]
    return types.SimpleNamespace(
        info=types.SimpleNamespace(train_cameras=infos, test_cameras=[],
                                   novel_view_cameras=[]),
        train_cameras=list(range(3)), novel_cameras=[], model_path=tmp,
        batch_for=lambda info: {})


def _schedule_events(pkg, cfg_mod, sample_iterations, scales, start_iter,
                     iterations, tmp):
    trainer_mod = __import__(f"{pkg}.runner.train", fromlist=["GSTrainer"])
    cfg = cfg_mod.default_config()
    cfg.train.iterations = iterations
    cfg.train.test_iterations = []
    cfg.diffusion.use_diffusion = True
    cfg.diffusion.sample_iterations = list(sample_iterations)
    cfg.diffusion.sds_scales = list(scales)
    trainer = object.__new__(trainer_mod.GSTrainer)
    trainer.cfg = cfg
    trainer.scene = _stand_in_scene(tmp)
    trainer.start_iter = start_iter
    trainer.rng = random.Random(0)
    trainer.state = None
    trainer._novel_cams = {}
    events = []
    trainer.run(diffusion_hook=lambda tr, it, scale, *masked:
                events.append((it, round(scale, 9))))
    return events


@pytest.mark.parametrize("sample_iterations,scales,start_iter,iterations", [
    ([3], [0.7], 1, 8),
    ([3, 5, 7, 9], [0.7, 0.6, 0.4, 0.3], 1, 10),
    ([3, 6], [0.7, 0.3], 7, 9),
    ([3, 6], [0.7, 0.3], 5, 9),
    ([2, 4], [0.3, 0.7], 3, 6),
])
def test_schedule_matches_jax(tmp_path, sample_iterations, scales,
                              start_iter, iterations):
    from street_crafter_tpu import config as jcfg
    from street_crafter_tpu_torch import config as pcfg
    args = (sample_iterations, scales, start_iter, iterations)
    want = _schedule_events("street_crafter_tpu", jcfg, *args,
                            str(tmp_path / "jax"))
    got = _schedule_events("street_crafter_tpu_torch", pcfg, *args,
                           str(tmp_path / "port"))
    assert got == want
    assert want, "the case runs no event"


# ------------------------------------------------------- masked guidance


def test_masked_guidance_has_no_effect(tmp_path):
    """Two runs that differ only in masked_guidance_iter, below and above
    the event, attach bit-equal novel images."""
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.datasets.synthetic import make_scene as pm
    from street_crafter_tpu_torch.runner.train import train
    scene_dir = pm(str(tmp_path), num_frames=3)
    images = []
    for it in (0, 10000):
        cfg = distill_config(default_config(), str(tmp_path / f"m{it}"),
                             scene_dir)
        cfg.train.iterations = 3
        cfg.train.checkpoint_iterations = []
        cfg.diffusion.masked_guidance_iter = it
        trainer = train(cfg)
        images.append([c._image for c in
                       trainer.scene.info.novel_view_cameras])
    assert len(images[0]) == 3
    for a, b in zip(*images):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ losses over N iterations

N_ITERS = 14
EVENT = 4


def loop_config(cfg, scene_dir, model_path, n_splats):
    """The training slice's settings (tests/test_torch_train.py) with the
    sampling schedule of one event, no flips, no densify."""
    from tests.test_torch_train import slice_config
    slice_config(cfg)
    cfg.source_path = scene_dir
    cfg.model_path = model_path
    cfg.seed = 3
    cfg.model.gaussian.flip_prob = 0.0
    cfg.optim.densify_from_iter = 10 ** 6
    cfg.optim.opacity_reset_interval = 10 ** 6
    cfg.train.iterations = N_ITERS
    cfg.train.test_iterations = []
    cfg.train.checkpoint_iterations = []
    cfg.train.log_interval = 1
    cfg.train.novel_view_prob = 0.5
    cfg.render.train_method = "xla"
    cfg.render.train_auto_capacity = False
    cfg.render.max_intersects_per_tile = n_splats
    cfg.render.max_intersects_per_coarse = n_splats
    d = cfg.diffusion
    d.use_diffusion = True
    d.height, d.width = DH, DW
    d.sample_iterations = [EVENT]
    d.sds_scales = [0.7]
    return cfg


def _record(trainer, seq):
    pick = trainer.pick_camera

    def recorded(pool):
        info, is_novel = pick(pool)
        seq.append((is_novel, info.image_name))
        return info, is_novel
    trainer.pick_camera = recorded


def test_losses_over_n_iterations_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from street_crafter_tpu.config import default_config as j_default
    from street_crafter_tpu.ops.lpips import lpips_distance as j_lpips
    from street_crafter_tpu.ops.lpips import random_lpips_params
    from street_crafter_tpu.runner import create_scene as j_scene
    from street_crafter_tpu.runner.train import GSTrainer as JTrainer
    from street_crafter_tpu.training.gs_trainer import init_train_state
    from street_crafter_tpu_torch.config import default_config as p_default
    from street_crafter_tpu_torch.models.gs.convert import (
        meta_from_dict, train_state_from_dict)
    from street_crafter_tpu_torch.ops.lpips import lpips_distance as p_lpips
    from street_crafter_tpu_torch.runner import create_scene as p_scene
    from street_crafter_tpu_torch.runner.train import GSTrainer as PTrainer
    from street_crafter_tpu_torch.utils.png import read_png, write_png

    scene_dir = make_scene(str(tmp_path / "data"), num_frames=3)
    # no gt value of exactly 0, where a render clamped at 0 ties with it:
    # d|x|/dx at 0 is 1 in JAX and 0 in torch (ROADMAP queue 3)
    img_dir = os.path.join(scene_dir, "images")
    for name in os.listdir(img_dir):
        p = os.path.join(img_dir, name)
        write_png(p, np.maximum(read_png(p), 1))

    jcfg = loop_config(j_default(), scene_dir, str(tmp_path / "jax"), 0)
    jscene = j_scene(jcfg)
    n = sum(int(np.prod(p.valid.shape)) for p in
            (jscene.params.bkgd, jscene.params.actors, jscene.params.sky))
    jcfg = loop_config(jcfg, scene_dir, str(tmp_path / "jax"), n)
    lp = {k: np.asarray(v) for k, v in
          random_lpips_params(jax.random.PRNGKey(0)).items()}
    # equal-depth splats of the grid-initialised actor sort differently
    # (stable sort, top_k): jitter them, as tests/test_torch_train.py does
    rng = np.random.default_rng(0)

    def jittered(pool, **scales):
        return pool.replace(**{k: getattr(pool, k) + jnp.asarray(rng.normal(
            0, sd, getattr(pool, k).shape), jnp.float32)
            for k, sd in scales.items()})

    params = dataclasses.replace(
        jscene.params, bkgd=jittered(jscene.params.bkgd, features_dc=1e-4),
        actors=jittered(jscene.params.actors, xyz=1e-3, features_dc=1e-4),
        sky=jittered(jscene.params.sky, features_dc=1e-4))
    jtrainer = JTrainer(jcfg, jscene,
                        lpips_fn=lambda a, b: j_lpips(lp, a, b))
    jtrainer.state = init_train_state(params)
    start = jax_tree_to_numpy(jtrainer.state)

    pcfg = loop_config(p_default(), scene_dir, str(tmp_path / "port"), n)
    pcfg.device = "cpu"
    pscene = p_scene(pcfg)
    pscene.meta = meta_from_dict(jax_tree_to_numpy(jscene.meta))
    ptrainer = PTrainer(pcfg, pscene,
                        lpips_fn=lambda a, b: p_lpips(lp, a, b))
    ptrainer.state = train_state_from_dict(start)

    novel_rng = np.random.default_rng(7)
    novel = [novel_rng.uniform(0.01, 1.0, (DH, DW, 3)).astype(np.float32)
             for _ in jscene.info.novel_view_cameras]

    def stand_in_hook(trainer, iteration, scale, *masked):
        for info, img in zip(trainer.scene.info.novel_view_cameras, novel):
            info._image = img
            info.metadata["diffusion_version"] = \
                info.metadata.get("diffusion_version", 0) + 1

    seqs, losses = {"jax": [], "port": []}, {"jax": [], "port": []}
    for name, trainer in (("jax", jtrainer), ("port", ptrainer)):
        _record(trainer, seqs[name])
        trainer.run(diffusion_hook=stand_in_hook,
                    log_fn=lambda it, vals, name=name:
                    losses[name].append(vals["loss"]))
    assert seqs["port"] == seqs["jax"]
    assert len(seqs["jax"]) == N_ITERS
    n_novel = sum(is_novel for is_novel, _ in seqs["jax"])
    assert 2 <= n_novel < N_ITERS - EVENT
    got, want = np.array(losses["port"]), np.array(losses["jax"])
    assert got.shape == want.shape == (N_ITERS,)
    drift = np.abs(got - want) / np.abs(want)
    print("per-iteration relative loss drift:",
          json.dumps([float(f"{d:.3g}") for d in drift]))
    assert drift.max() <= LOSS_RTOL, drift

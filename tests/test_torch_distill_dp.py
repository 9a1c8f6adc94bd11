"""Distillation on several ranks (``runner.train`` with
``diffusion.use_diffusion`` on a mesh) on the CPU, over spawned gloo ranks
(``parallel.mesh.run_ranks``, each call with a timeout of its own).

(a) The loop against JAX: the JAX ``GSTrainer`` at ``train.batch_size`` 2
    on its virtual CPU devices (camera-data-parallel over a ``data`` axis
    of 2) against the port on two ranks at batch 2, from one JAX train
    state on tests/test_torch_distill.py's tiny scene, with a stand-in
    hook that attaches the same numpy novel images in both; flips and
    densify off. The same cameras (the first of each step, novel or
    train, and the whole batch), and per-iteration losses within LOSS_RTOL
    (tests/test_torch_train.py's one-step 2e-4 relative, held over the
    run, as ``test_losses_over_n_iterations_match_jax``).
(b) The real hook with the tiny engine (T = 4, f32) through
    ``runner.train.main`` at batch 2 on ``{data: 2}`` and, frames-sharded
    (``diffusion.shard_sample``), on ``{data: 2, frames: 2}`` (four
    ranks): every rank's novel images bit-equal to each other and within
    SAMPLE_ATOL of the largest |frame| of the one-process run (the
    runner's tolerance, tests/test_torch_diffusion.py), rank 0 alone wrote
    the diffusion and condition PNGs, the ranks off data index 0 built no
    engine, and the states are bit-equal after the run.
(c) Then its resume from the checkpoint at 6 with events at 3 and 6: the
    event of 6 runs again at 7 on every rank, and the ranks stay equal.
(d) The condition barrier: a rank without a processor (every rank but 0
    under ``runner.train``) enters it too, so the PNG rank 0 writes is
    there when the call returns on every rank and the collective after it
    pairs up (before the repair the other ranks skipped the barrier: rank
    0 waited in it until the call timed out).
"""

import os

import numpy as np
import pytest
import torch

from street_crafter_tpu_torch.config import save_config, to_dict
from street_crafter_tpu_torch.parallel.mesh import run_ranks
from tests import torch_dp_ranks as R
from tests.test_torch_distill import DH, DW, LOSS_RTOL, distill_config
from tests.test_torch_gs_dp import _assert_equal
from tests.torch_port_helpers import jax_tree_to_numpy

SAMPLE_ATOL = 1e-3
N_ITERS = 14
EVENT = 4
NOVEL_PROB = 0.7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- (a) the loop against JAX

def _loop_config(cfg, scene_dir, model_path, n_splats):
    from tests.test_torch_distill import loop_config
    cfg = loop_config(cfg, scene_dir, model_path, n_splats)
    cfg.train.batch_size = 2
    cfg.train.iterations = N_ITERS
    cfg.train.novel_view_prob = NOVEL_PROB
    cfg.diffusion.sample_iterations = [EVENT]
    return cfg


def test_batch_two_loop_on_two_ranks_matches_jax(tmp_path, monkeypatch):
    import dataclasses

    import jax
    import jax.numpy as jnp

    import time

    import street_crafter_tpu.parallel as jpar
    from street_crafter_tpu.config import default_config as j_default
    from street_crafter_tpu.ops.lpips import lpips_distance as j_lpips
    from street_crafter_tpu.ops.lpips import random_lpips_params
    from street_crafter_tpu.runner import create_scene as j_scene
    from street_crafter_tpu.runner.train import GSTrainer as JTrainer
    from street_crafter_tpu.training.gs_trainer import init_train_state
    from street_crafter_tpu_torch.config import default_config as p_default
    from street_crafter_tpu_torch.utils.png import read_png, write_png
    from tests.synthetic_scene import make_scene

    scene_dir = make_scene(str(tmp_path / "data"), num_frames=3)
    # no gt value of exactly 0 (d|x|/dx at 0 differs; ROADMAP queue 3)
    img_dir = os.path.join(scene_dir, "images")
    for name in os.listdir(img_dir):
        p = os.path.join(img_dir, name)
        write_png(p, np.maximum(read_png(p), 1))

    jcfg = _loop_config(j_default(), scene_dir, str(tmp_path / "jax"), 0)
    jscene = j_scene(jcfg)
    n = sum(int(np.prod(p.valid.shape)) for p in
            (jscene.params.bkgd, jscene.params.actors, jscene.params.sky))
    jcfg = _loop_config(jcfg, scene_dir, str(tmp_path / "jax"), n)
    # camera-DP over a data axis of 2: two of the virtual devices
    make_mesh = jpar.make_mesh
    monkeypatch.setattr(jpar, "make_mesh", lambda spec: make_mesh(
        spec, devices=jax.devices()[:2]))
    jcfg.mesh.axes = {"data": 2}
    lp = {k: np.asarray(v) for k, v in
          random_lpips_params(jax.random.PRNGKey(0)).items()}
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
    meta = jax_tree_to_numpy(jscene.meta)

    novel_rng = np.random.default_rng(7)
    novel = [novel_rng.uniform(0.01, 1.0, (DH, DW, 3)).astype(np.float32)
             for _ in jscene.info.novel_view_cameras]

    picks, batches, losses = [], [], []
    pick, fill = jtrainer.pick_camera, jtrainer.fill_camera_batch

    def recorded_pick(pool):
        info, is_novel = pick(pool)
        picks.append((is_novel, info.image_name))
        return info, is_novel

    def recorded_fill(info, is_novel, pool, B):
        infos = fill(info, is_novel, pool, B)
        batches.append([i.image_name for i in infos])
        return infos
    jtrainer.pick_camera = recorded_pick
    jtrainer.fill_camera_batch = recorded_fill

    def stand_in_hook(trainer, iteration, scale, *masked):
        for info, img in zip(trainer.scene.info.novel_view_cameras, novel):
            info._image = img
            info.metadata["diffusion_version"] = \
                info.metadata.get("diffusion_version", 0) + 1

    t0 = time.perf_counter()
    jtrainer.run(diffusion_hook=stand_in_hook,
                 log_fn=lambda it, vals: losses.append(vals["loss"]))
    print(f"JAX loop {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    pcfg = _loop_config(p_default(), scene_dir, str(tmp_path / "port"), n)
    pcfg.device = "cpu"
    ranks = run_ranks(R.distill_loop, 2, str(tmp_path), to_dict(pcfg),
                      meta, start, lp, novel, timeout_s=300)
    print(f"port ranks {time.perf_counter() - t0:.1f} s")
    for r in ranks:
        assert r["picks"] == picks
        assert r["batches"] == batches
    assert len(picks) == N_ITERS
    n_novel = sum(is_novel for is_novel, _ in picks)
    assert 2 <= n_novel < N_ITERS - EVENT
    # two different cameras in some batch: the ranks' halves differ
    assert any(len(set(b)) == 2 for b in batches)
    _assert_equal(ranks[1]["state"], ranks[0]["state"])
    assert ranks[1]["losses"] == []                  # rank 0 logs
    got, want = np.array(ranks[0]["losses"]), np.array(losses)
    assert got.shape == want.shape == (N_ITERS,)
    drift = np.abs(got - want) / np.abs(want)
    print("per-iteration relative loss drift:", drift.max())
    assert drift.max() <= LOSS_RTOL, drift


# ------------------------------------------- (b), (c) the real hook, resume

@pytest.fixture(scope="module")
def distill_runs(tmp_path_factory):
    """runner.train.main at batch 2 with the tiny engine, on one process,
    on {data: 2} (then its resume) and on {data: 2, frames: 2}
    frames-sharded."""
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.datasets.synthetic import make_scene as pm
    root = tmp_path_factory.mktemp("torch_distill_dp")
    cfg = distill_config(default_config(), str(root), "")
    cfg.train.batch_size = 2
    path = str(root / "cfg.json")
    save_config(cfg, path)

    def run(name):
        # a scene of its own: its condition PNGs are written in this run
        return [f"source_path={pm(str(root / name), num_frames=3)}",
                f"model_path={root / name / 'model'}"]
    resume = ["resume=true", "diffusion.sample_iterations=[3,6]",
              "diffusion.sds_scales=[0.7,0.3]"]
    one = R.distill_main(None, path, run("one"), None)
    two = run("two")
    two = run_ranks(R.distill_main, 2, str(root), path, two, two + resume,
                    timeout_s=300)
    four = run_ranks(R.distill_main, 4, str(root), path,
                     run("four") + ["mesh.axes.data=2", "mesh.axes.frames=2",
                                    "diffusion.shard_sample=true"],
                     None, timeout_s=300)
    return {"one": one, 2: two, 4: four}


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_attach_equal_images(distill_runs, world):
    one = distill_runs["one"]["first"]
    ranks = distill_runs[world]
    assert one["events"] == [3]
    ref = np.stack(one["images"])
    assert ref.shape == (3, DH, DW, 3)
    for r in ranks:
        f = r["first"]
        assert f["events"] == [3] and f["versions"] == [1, 1, 1]
        imgs = np.stack(f["images"])
        assert np.isfinite(imgs).all()
        np.testing.assert_array_equal(imgs, np.stack(
            ranks[0]["first"]["images"]))
        err = np.abs(imgs - ref).max() / np.abs(ref).max()
        assert err <= SAMPLE_ATOL, err
        _assert_equal(f["state"], ranks[0]["first"]["state"])
        assert int(f["state"]["step"]) == 8


@pytest.mark.parametrize("world", [2, 4])
def test_rank_0_writes_and_data_0_samples(distill_runs, world):
    ranks = distill_runs[world]
    shard = world == 4                # {data: 2, frames: 2}: 0, 1 sample
    for r in ranks:
        data0 = r["rank"] < (2 if shard else 1)
        # one hook a run: {data: 2} ran twice (then resumed)
        assert r["samples"] == [data0] * (1 if shard else 2)
        assert r["first_log"]["engines"] == int(data0)
        wrote = r["rank"] == 0
        assert (r["first_log"]["pngs"] > 0) == wrote
        assert (r["first_log"]["conditions"] > 0) == wrote
    assert ranks[0]["first_log"]["pngs"] == 3          # the novel frames
    first = [n for n in ranks[0]["files"] if n.endswith("_scale0.7.png")]
    assert len(first) == 3


def test_resume_reruns_the_event_on_every_rank(distill_runs):
    for r in distill_runs[2]:
        res = r["resumed"]
        assert res["start_iter"] == 7 and int(res["state"]["step"]) == 8
        assert res["events"] == [7]
        assert res["versions"] == [1, 1, 1]
        np.testing.assert_array_equal(
            np.stack(res["images"]),
            np.stack(distill_runs[2][0]["resumed"]["images"]))
        _assert_equal(res["state"], distill_runs[2][0]["resumed"]["state"])
    assert distill_runs[2][0]["log"]["pngs"] == 6
    assert distill_runs[2][1]["log"] == {"engines": 0, "pngs": 0,
                                         "conditions": 0}


# ------------------------------------------------- (d) the condition barrier

def test_every_rank_enters_the_condition_barrier(tmp_path):
    ranks = run_ranks(R.condition_barrier, 2, str(tmp_path), str(tmp_path),
                      timeout_s=60)
    assert [r["seen"] for r in ranks] == [True, True]
    assert [r["sum"] for r in ranks] == [3.0, 3.0]

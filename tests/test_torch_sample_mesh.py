"""The port's frames-sharded sampler (``parallel/sample.py``,
``engine.sample(frames=)``, ``DiffusionRunner(mesh=)``,
``runner.vdm_sample`` with ``diffusion.shard_sample``) on the CPU over
spawned gloo ranks, the tiny engine (T = 4, 32x32, 3 Euler steps, f32)
holding the JAX engine's seeded random parameters and the JAX sampler's
own noise.

* ``sample_on_mesh`` on ``{frames: 2}`` and ``{data: 2, frames: 2}``,
  without and with the SDS start, against JAX's ``engine.sample`` and
  JAX's ``sample_on_mesh`` on ``{frames: 4, data: 2}`` (eight virtual CPU
  devices): atol 2e-4, rtol 1e-3, as ``tests/test_sample_mesh.py``; and
  against the port on one process (the same tolerance).
* ``DiffusionRunner`` with a mesh against one without; the chunked decode
  with the chunks spread over the frames ranks equal to one process's.
* A frames size that does not divide T raises "not divisible";
  ``sampling_mesh_from_cfg`` returns None without ``shard_sample`` or on
  one process, and the frames mesh on two ranks.
* ``runner.vdm_sample.main`` with ``shard_sample`` on two ranks: rank 0
  writes PNGs within 1 (uint8) of one process's, rank 1 writes nothing,
  and both ranks hold the whole sample.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu.parallel import make_virtual_cpu_mesh
from street_crafter_tpu.parallel import sample_on_mesh as j_sample_on_mesh
from street_crafter_tpu_torch.config import Config
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm.engine import EngineConfig
from street_crafter_tpu_torch.parallel.mesh import Mesh, run_ranks
from street_crafter_tpu_torch.parallel.sample import (sample_on_mesh,
                                                      shard_window_inputs)
from tests import torch_sp_ranks as SR
from tests.test_torch_vdm_sample import _synthetic_clip_root
from tests.torch_port_helpers import random_params

T, H, W = SR.SAMPLE_T, 32, 32
ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    """JAX: the tiny engine's seeded random parameters as the port's state
    dicts, the window's inputs, the noise of each key, and JAX's samples
    (one device; on the {frames: 4, data: 2} mesh)."""
    jeng = JEngine(JEngineConfig.tiny(num_frames=T, num_steps=3))
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, H, W), jax.random.PRNGKey(0)), 13)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    sd = {p: {k: v.numpy() for k, v in s.items()} for p, s in
          PCV.engine_params_from_jax(params, EngineConfig.tiny(
              num_frames=T, num_steps=3)).items()}
    rng = np.random.default_rng(7)
    guide = rng.uniform(-1, 1, (T, H, W, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    render = rng.uniform(-1, 1, (T, H, W, 3)).astype(np.float32)
    keys = {"plain": jax.random.PRNGKey(3), "sds": jax.random.PRNGKey(5)}
    noise = {k: np.asarray(jax.random.normal(key, (T, H // 2, W // 2, 4)))
             for k, key in keys.items()}
    g, c, r = map(jnp.asarray, (guide, cond, render))
    mesh = make_virtual_cpu_mesh(8, {"frames": 4, "data": 2})
    want = {"plain": np.asarray(jeng.sample(params, keys["plain"], g, c)),
            "sds": np.asarray(jeng.sample(params, keys["sds"], g, c,
                                          render_images=r, sds_scale=0.5)),
            "mesh": np.asarray(j_sample_on_mesh(jeng, params, keys["plain"],
                                                g, c, mesh=mesh),
                               np.float32)}
    return dict(sd=sd, guide=guide, cond=cond, render=render, noise=noise,
                want=want)


@pytest.fixture(scope="module")
def runs(jax_side, tmp_path_factory):
    j = jax_side
    args = (j["sd"], j["guide"], j["cond"], j["render"], j["noise"]["plain"],
            j["noise"]["sds"])
    tmp = str(tmp_path_factory.mktemp("sample_mesh"))
    one = SR.sampling(None, None, *args, True)
    two = run_ranks(SR.suite, 2, tmp, [
        ("sample", "sampling", ({"frames": 2},) + args + (True,)),
        ("gating", "gating", ())], timeout_s=300)
    four = run_ranks(SR.suite, 4, tmp, [
        ("sample", "sampling", ({"data": 2, "frames": 2},) + args
         + (False,))], timeout_s=300)
    return {"one": one, 2: two, 4: four}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "sds"])
def test_sharded_sample_matches_jax_and_one_process(jax_side, runs, world,
                                                    kind):
    want = jax_side["want"]
    one = runs["one"][kind]
    for r in runs[world]:
        got = r["sample"][kind]
        assert got.shape == (T, H, W, 3)
        np.testing.assert_allclose(got, want[kind], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, one, atol=ATOL, rtol=RTOL)
        if kind == "plain":
            np.testing.assert_allclose(got, want["mesh"], atol=ATOL,
                                       rtol=RTOL)
    np.testing.assert_allclose(one, want[kind], atol=ATOL, rtol=RTOL)
    # every rank holds the whole window
    for r in runs[world][1:]:
        np.testing.assert_array_equal(r["sample"][kind],
                                      runs[world][0]["sample"][kind])


def test_runner_dispatch_and_spread_decode(runs):
    one = runs["one"]
    for r in runs[2]:
        s = r["sample"]
        np.testing.assert_allclose(s["runner"], one["runner"], atol=ATOL,
                                   rtol=RTOL)
        for got, want in zip(s["decode"], one["decode"]):
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_indivisible_frames_axis_rejected(jax_side):
    eng = SR.sample_engine(jax_side["sd"])
    g, c = torch.tensor(jax_side["guide"]), torch.tensor(jax_side["cond"])
    for f in (3, 8):
        with pytest.raises(ValueError, match="not divisible"):
            sample_on_mesh(eng, g, c, Mesh(shape={"frames": f}))


def test_shard_window_inputs():
    mesh = Mesh(shape={"data": 2, "frames": 2}, rank=3)
    tree = {"guide": torch.arange(T * 2.0).reshape(T, 2),
            "cond": [torch.zeros(1, 5)], "n": 3}
    out = shard_window_inputs(mesh, T, tree)
    assert torch.equal(out["guide"], tree["guide"][2:])
    assert out["cond"][0].shape == (1, 5) and out["n"] == 3


def test_sampling_mesh_from_cfg_gating(runs):
    from street_crafter_tpu_torch.runner.diffusion import \
        sampling_mesh_from_cfg
    for flag in (False, True):
        cfg = Config(dict(device="cpu", diffusion=dict(shard_sample=flag),
                          mesh=dict(axes=dict(data=1, frames=-1))))
        assert sampling_mesh_from_cfg(cfg) is None      # one process
    for r in runs[2]:
        assert r["gating"] == {False: None,
                               True: {"data": 1, "frames": 2}}


def test_vdm_sample_main_on_two_ranks(tmp_path):
    from street_crafter_tpu_torch.runner import vdm_sample
    from street_crafter_tpu_torch.utils.png import read_png
    root = _synthetic_clip_root(str(tmp_path / "data"))
    cfg = {"device": "cpu",
           "diffusion": {"tiny": True, "num_steps": 2},
           "vdm_train": {"data_root": root, "height": 32, "width": 48,
                         "num_frames": T}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    one = vdm_sample.main(["--config", str(path), "--num-clips", "1",
                           f"model_path={tmp_path / 'one'}"])
    ranks = run_ranks(SR.vdm_sample_main, 2, str(tmp_path), str(path),
                      str(tmp_path / "two"), timeout_s=300)
    assert ranks[0]["wrote"] and not ranks[1]["wrote"]
    assert ranks[1]["clips"] == []
    for r in ranks:
        np.testing.assert_allclose(r["frames"], one["frames"], atol=ATOL,
                                   rtol=RTOL)
    for clip in one["clips"]:
        got_dir = clip.replace(str(tmp_path / "one"), str(tmp_path / "two"))
        names = sorted(os.listdir(clip))
        assert sorted(os.listdir(got_dir)) == names and len(names) == T
        for name in names:
            a = read_png(os.path.join(clip, name)).astype(int)
            b = read_png(os.path.join(got_dir, name)).astype(int)
            assert np.abs(a - b).max() <= 1, name

"""The port's ensemble reward (street_crafter_tpu_torch.runner.reward)
against the JAX package's runner/reward.py, on the CPU: JAX's
tests/test_reward.py cases held against the port.

Tolerances: ``reward_from_samples`` within 1e-6 relative (f32 means and
sums in another order); the tiny ensemble fed JAX's own noise: samples
within 1e-3 of the largest |latent| (test_torch_vdm_sample.py's
SAMPLE_RTOL: a whole sample from sigma 700 in f32) and the reward within
1e-4 relative, every member's frame 0 equal to the real latent;
``get_sample`` and ``load_reward_image`` equal (Pillow's LANCZOS, in the
port's own fixed-point resize).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu.runner import reward as JR
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm import weights as PW
from street_crafter_tpu_torch.models.vdm.engine import (EngineConfig,
                                                        VideoDiffusionEngine)
from street_crafter_tpu_torch.runner import reward as PR
from street_crafter_tpu_torch.utils.png import write_png
from tests.torch_port_helpers import random_params

SAMPLE_RTOL = 1e-3
T, H, W = 3, 32, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reward_from_samples_closed_form():
    s = torch.arange(6.0).reshape(2, 3).expand(4, 2, 3)
    assert float(PR.reward_from_samples(s)) == pytest.approx(1.0)
    d = 0.5
    s2 = torch.stack([torch.zeros(2, 3) - d, torch.zeros(2, 3) + d])
    assert float(PR.reward_from_samples(s2)) == pytest.approx(
        np.exp(-2 * d * d), rel=1e-5)
    x = np.random.default_rng(0).normal(0, 0.3, (4, 3, 5, 6, 4)).astype(
        np.float32)
    assert float(PR.reward_from_samples(torch.tensor(x))) == pytest.approx(
        float(JR.reward_from_samples(jnp.asarray(x))), rel=1e-6)


@pytest.fixture(scope="module")
def engines():
    jeng = JEngine(JEngineConfig.tiny(num_frames=T, num_steps=3))
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, H, W), jax.random.PRNGKey(0)), 13)
    cfg = EngineConfig.tiny(num_frames=T, num_steps=3)
    peng = VideoDiffusionEngine(cfg, "cpu")
    PW.load_state_dicts(peng, PCV.engine_params_from_jax(params, cfg))
    return jeng, params, peng


def test_ensemble_reward_tiny(engines):
    """JAX's ensemble with its key; the port's with JAX's noise per member
    (the normals of ``jax.random.split(key, E)``)."""
    jeng, params, peng = engines
    E = 3
    images = np.asarray(jax.random.uniform(jax.random.PRNGKey(1),
                                           (T, H, W, 3)) * 2 - 1)
    key = jax.random.PRNGKey(2)
    reward, samples = JR.ensemble_reward(jeng, params, jnp.asarray(images),
                                         key, ensemble_size=E, num_steps=3)
    want = np.asarray(samples)
    noises = np.stack([np.asarray(jax.random.normal(k, want.shape[1:]))
                       for k in jax.random.split(key, E)])
    got_r, got = PR.ensemble_reward(peng, torch.tensor(images),
                                    ensemble_size=E, num_steps=3,
                                    noises=torch.tensor(noises))
    got = got.numpy()
    assert got.shape == want.shape == (E, T, H // 2, W // 2, 4)
    assert np.abs(got - want).max() <= SAMPLE_RTOL * np.abs(want).max()
    assert float(got_r) == pytest.approx(float(reward), rel=1e-4)
    r = float(got_r)
    assert np.isfinite(r) and 0.0 < r <= 1.0
    z0 = peng.encode_images_chunked(torch.tensor(images))[0]
    for e in range(E):
        assert torch.equal(torch.tensor(got[e, 0]), z0)
    # drawn from a generator: deterministic in its seed
    a = PR.ensemble_reward(peng, torch.tensor(images),
                           torch.Generator().manual_seed(5),
                           ensemble_size=2, num_steps=2)
    b = PR.ensemble_reward(peng, torch.tensor(images),
                           torch.Generator().manual_seed(5),
                           ensemble_size=2, num_steps=2)
    assert torch.equal(a[1], b[1]) and float(a[0]) == float(b[0])


def test_get_sample_matches_jax(tmp_path):
    for i in range(3):
        Image.new("RGB", (8, 6)).save(tmp_path / f"im{i}.png")
    assert PR.get_sample(4, "IMG", str(tmp_path), num_frames=5) == \
        JR.get_sample(4, "IMG", str(tmp_path), num_frames=5)
    paths, idx, n, action = PR.get_sample(4, "IMG", str(tmp_path),
                                          num_frames=5)
    assert n == 3 and idx == 1 and len(paths) == 5 and action is None
    anno = [{"frames": [f"f{i}.png" for i in range(4)],
             "traj": [0, 0, 1, 2, 3, 4], "cmd": 2,
             "speed": [5, 6, 7], "angle": [78, 156],
             "z": 1.0, "goal": [800, 450]}]
    af = tmp_path / "anno.json"
    af.write_text(json.dumps(anno))
    for mode in ("traj", "cmd", "steer", "goal"):
        got = PR.get_sample(0, "NUSCENES", str(tmp_path), str(af),
                            num_frames=4, action_mode=mode)
        want = JR.get_sample(0, "NUSCENES", str(tmp_path), str(af),
                             num_frames=4, action_mode=mode)
        assert got[:3] == want[:3]
        assert set(got[3]) == set(want[3])
        for k in got[3]:
            np.testing.assert_array_equal(got[3][k], want[3][k])
    with pytest.raises(ValueError):
        PR.get_sample(0, "KITTI", str(tmp_path))


@pytest.mark.parametrize("hw", [(10, 20), (20, 10), (30, 30), (37, 53)])
def test_load_reward_image_matches_jax(tmp_path, hw):
    """Center crop on both axes, then Lanczos: the port's PNG reader and
    resize against JAX's Pillow path, equal."""
    rng = np.random.default_rng(hw[0])
    arr = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    arr[:, hw[1] // 2:] //= 4                 # the crop's side matters
    p = tmp_path / "x.png"
    write_png(str(p), arr)
    for th, tw in ((8, 8), (12, 20), (16, 6)):
        got = PR.load_reward_image(str(p), th, tw)
        want = JR.load_reward_image(str(p), th, tw)
        assert got.shape == want.shape == (th, tw, 3)
        np.testing.assert_array_equal(got, want)
    gray = tmp_path / "g.png"
    write_png(str(gray), arr[..., 0])
    np.testing.assert_array_equal(PR.load_reward_image(str(gray), 8, 8),
                                  JR.load_reward_image(str(gray), 8, 8))


def test_reward_main_writes_rewards_jsonl(tmp_path):
    """The CLI on the tiny engine: JAX's flags, one record a sample
    appended to rewards.jsonl, the reward of ``ensemble_reward`` with the
    seed's generator."""
    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        write_png(str(data / f"{i:02d}.png"),
                  rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
    save = tmp_path / "out"
    argv = ["--dataset", "IMG", "--data_root", str(data), "--save",
            str(save), "--n_frames", "3", "--ens_size", "2", "--n_steps",
            "2", "--height", "16", "--width", "16", "--count", "2",
            "--index", "1", "device=cpu", "diffusion.tiny=true"]
    recs = PR.main(argv)
    lines = [json.loads(x) for x in
             (save / "rewards.jsonl").read_text().splitlines()]
    assert lines == recs and len(recs) == 2
    assert [r["index"] for r in recs] == [1, 0]
    for r in recs:
        assert set(r) == {"index", "reward", "frames", "action_keys"}
        assert 0.0 < r["reward"] <= 1.0 and r["action_keys"] == []
    assert recs[0]["frames"] == [os.path.join(str(data), "01.png")]
    # the same engine and seed again: the same rewards, appended
    again = PR.main(argv)
    assert [r["reward"] for r in again] == [r["reward"] for r in recs]
    assert len((save / "rewards.jsonl").read_text().splitlines()) == 4

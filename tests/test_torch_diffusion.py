"""The port's diffusion runner (street_crafter_tpu_torch.runner.diffusion)
against the JAX package's, on the CPU with the tiny engine in f32: the
JAX parameters (seeded random values) carried across by
``convert.engine_params_from_jax``, both runners reading the same
condition and camera PNGs, and JAX's noise (``PRNGKey(seed)``, the same for
every window) put into the port's ``engine.sample`` by a wrapper in the
test.

Tolerances: ``crop_resize_K`` and ``diffusion_camera`` to 1e-6; the same
windows fill the same frames; the frames to SAMPLE_RTOL = 1e-3 of the
largest |frame| (tests/test_torch_vdm_sample.py's whole-sample tolerance:
f32 cancellation at sigma_max 700); the weights' host store on and off
bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.datasets.readers import CameraInfo as JCameraInfo
from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu.runner import diffusion as JD
from street_crafter_tpu_torch.datasets.readers import CameraInfo
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm import weights as PW
from street_crafter_tpu_torch.models.vdm.engine import (EngineConfig,
                                                        VideoDiffusionEngine)
from street_crafter_tpu_torch.runner import diffusion as PD
from street_crafter_tpu_torch.utils.png import write_png
from tests.torch_port_helpers import random_params

torch.set_num_threads(1)

SAMPLE_RTOL = 1e-3
T = 4                 # frames a window: 3 novel frames after the cond frame
TH, TW = 32, 48       # diffusion size
IMG_H, IMG_W = 48, 64


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("h,w,th,tw", [(48, 64, 32, 64), (48, 64, 32, 32),
                                       (1280, 1920, 576, 1024),
                                       (60, 64, 60, 64)])
def test_crop_resize_K_and_camera(h, w, th, tw):
    K = np.array([[100.0, 0, w / 2 + 1.5], [0, 90.0, h / 2 - 2], [0, 0, 1]])
    got = PD.crop_resize_K(K, h, w, th, tw)
    want = JD.crop_resize_K(K, h, w, th, tw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    meta = dict(frame=3, cam=0, timestamp=1.25)
    kw = dict(uid=7, R=R, T=rng.normal(size=3), K=K, width=w, height=h,
              image_name="000003_0", metadata=meta)
    pc = PD.diffusion_camera(CameraInfo(**kw), th, tw)
    jc = JD.diffusion_camera(JCameraInfo(**kw), th, tw)
    assert (pc.width, pc.height, pc.id, pc.frame, pc.image_name) == (
        jc.width, jc.height, jc.id, jc.frame, jc.image_name)
    for name in ("K", "w2c"):
        np.testing.assert_allclose(getattr(pc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def engines():
    jcfg = JEngineConfig.tiny(num_frames=T, num_steps=2)
    jeng = JEngine(jcfg)
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, TH, TW), jax.random.PRNGKey(0)), 21)
    peng = VideoDiffusionEngine(EngineConfig.tiny(num_frames=T, num_steps=2),
                                "cpu")
    PW.load_state_dicts(peng, PCV.engine_params_from_jax(params, peng.cfg))
    return jeng, params, peng


@pytest.fixture(scope="module")
def cameras(tmp_path_factory):
    """Camera PNGs and condition PNGs of 7 frames; each test gets fresh
    CameraInfo objects of both packages over the same files."""
    root = tmp_path_factory.mktemp("diffusion_runner")
    rng = np.random.default_rng(3)
    files = {}
    for f in range(7):
        for kind in ("image", "guide", "novel_guide"):
            path = str(root / f"{kind}_{f}.png")
            write_png(path, rng.integers(0, 256, (IMG_H, IMG_W, 3),
                                         dtype=np.uint8))
            files[kind, f] = path
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])

    def make(cls, frames, novel):
        out = []
        for f in frames:
            meta = {"frame": f, "cam": 0, "novel_view_id": 2.0,
                    "guidance_rgb_path": files["novel_guide" if novel
                                               else "guide", f]}
            out.append(cls(uid=f, R=np.eye(3), T=np.zeros(3), K=K,
                           width=IMG_W, height=IMG_H,
                           image_path=files["image", f],
                           image_name=f"{f:06d}_0" + ("_n" if novel else ""),
                           metadata=meta))
        return out
    return make


def spies(jeng, peng, calls):
    """Record each window on both sides; the port's sample takes the JAX
    sample's noise (PRNGKey(seed), as the JAX runner draws it)."""
    j_orig, p_orig = jeng.sample, peng.sample

    def j_spy(params, key, **kw):
        calls["jax"].append((kw["guide_images"].shape[0],
                             tuple(kw["cond_indices"]),
                             np.asarray(kw["guide_images"])))
        return j_orig(params, key, **kw)

    def p_spy(**kw):
        kw.pop("generator")
        calls["port"].append((kw["guide_images"].shape[0],
                              tuple(kw["cond_indices"]),
                              kw["guide_images"].numpy()))
        noise = jax.random.normal(jax.random.PRNGKey(PD.SEED),
                                  (T, TH // 2, TW // 2, 4))
        return p_orig(noise=torch.tensor(np.asarray(noise)), **kw)

    jeng.sample, peng.sample = j_spy, p_spy


@pytest.fixture
def runners(engines):
    jeng, params, peng = engines
    calls = {"jax": [], "port": []}
    spies(jeng, peng, calls)
    kw = dict(height=TH, width=TW, window_size=1, num_steps=2)
    yield (JD.DiffusionRunner(None, jeng, params, **kw),
           PD.DiffusionRunner(None, peng, **kw), calls)
    del jeng.sample, peng.sample


def check_windows(calls):
    assert len(calls["jax"]) == len(calls["port"]) > 1
    for (jn, jc, jg), (pn, pc, pg) in zip(calls["jax"], calls["port"]):
        assert (jn, jc) == (pn, pc)
        np.testing.assert_array_equal(pg, jg)   # the same Lanczos


def test_run_sequence_matches_jax(runners, cameras, tmp_path):
    jr, pr, calls = runners
    jr.save_dir = str(tmp_path / "jax")
    pr.save_dir = str(tmp_path / "port")
    j_novel, p_novel = cameras(JCameraInfo, range(6), True), \
        cameras(CameraInfo, range(6), True)
    j_train = cameras(JCameraInfo, (0, 2, 5), False)
    p_train = cameras(CameraInfo, (0, 2, 5), False)
    rng = np.random.default_rng(5)
    renders = {f: rng.uniform(0, 1, (TH, TW, 3)).astype(np.float32)
               for f in range(6)}
    want = jr.run_sequence(
        j_novel, j_train, scale=0.5,
        render_fn=lambda c: {"rgb": jnp.asarray(renders[c.metadata["frame"]])})
    got = pr.run_sequence(
        p_novel, p_train, scale=0.5,
        render_fn=lambda c: {"rgb": torch.tensor(renders[c.metadata["frame"]])})
    check_windows(calls)
    # windows of 3 novel frames, step 2 over 6: starts 0, 2 and 3
    assert [c[0] for c in calls["port"]] == [T, T, T]
    assert got.shape == want.shape == (6, TH, TW, 3)
    assert rel_err(got, want) <= SAMPLE_RTOL
    print(f"run_sequence frames: {rel_err(got, want):.3g} of the largest")
    for cam, frame in zip(p_novel, got):
        assert cam.metadata["diffusion_version"] == 1
        np.testing.assert_array_equal(cam._image, frame)
    assert sorted(os.listdir(pr.save_dir)) == sorted(os.listdir(jr.save_dir))


def test_run_interleaved_matches_jax(runners, cameras):
    jr, pr, calls = runners
    train, test = (0, 2, 3, 5), (1, 4, 6)
    want = jr.run_interleaved(cameras(JCameraInfo, test, False),
                              cameras(JCameraInfo, train, False))
    p_test = cameras(CameraInfo, test, False)
    got = pr.run_interleaved(p_test, cameras(CameraInfo, train, False))
    check_windows(calls)
    # windows of 4 frames, step 3 over 7 frames: starts 0, 3 and 6 (moved
    # back to 3); the train frames in each are conditions
    assert [c[1] for c in calls["port"]] == [(0, 2, 3), (0, 2), (0, 2)]
    assert got.shape == want.shape == (3, TH, TW, 3)
    assert rel_err(got, want) <= SAMPLE_RTOL
    print(f"run_interleaved frames: {rel_err(got, want):.3g} of the largest")
    assert all(c.metadata["diffusion_version"] == 1 for c in p_test)


def test_param_store_on_and_off_bit_equal(engines, cameras):
    _, _, peng = engines
    outs = []
    for on_host in (False, True):
        store = PD.EngineParamStore(peng, on_host)
        assert store.host_resident == on_host
        assert store.nbytes == sum(
            p.numel() * p.element_size() for m in peng.modules().values()
            for p in list(m.parameters()) + list(m.buffers()))
        runner = PD.DiffusionRunner(None, store.acquire(), height=TH,
                                    width=TW, window_size=1, num_steps=2)
        try:
            outs.append(runner.run_sequence(
                cameras(CameraInfo, range(3), True),
                cameras(CameraInfo, (0, 2), False)))
        finally:
            store.release()
        assert store.host_resident == on_host
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.isfinite(outs[0]).all() and outs[0].shape == (3, TH, TW, 3)


def test_resolve_params_on_host():
    from street_crafter_tpu_torch.config import Config
    for v, dev, want in (("auto", "cuda", True), ("auto", "cpu", False),
                         ("true", "cpu", True), (False, "cuda", False)):
        assert PD.resolve_params_on_host(Config(params_on_host=v),
                                         dev) == want

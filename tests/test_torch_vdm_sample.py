"""The port's sampling slice (street_crafter_tpu_torch: engine, weights,
data and ``runner.vdm_sample``) against the JAX engine's own pieces on the
tiny engine, on the CPU, in f32, with the same numpy noise and the JAX
parameters (seeded random values) carried across by
``convert.engine_params_from_jax``.

Tolerances, with their reasons: 1e-5 of the largest |value| for the f32
pieces (the same arithmetic in another order); 1e-3 for a whole sample
(SAMPLE_RTOL: f32 cancellation at sigma_max 700, measured 3.1e-4); the
checkpoint readers are exact and the LoRA/EMA merges agree to 1e-6 (one
f32 matmul).
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.vdm import convert as JCV
from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu_torch.config import Config
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm import weights as PW
from street_crafter_tpu_torch.models.vdm.engine import (EngineConfig,
                                                        VideoDiffusionEngine)
from tests.torch_port_helpers import random_params

RTOL = 1e-5
# a whole sample: the first Euler step from sigma 700 cancels x0 ~ 700 *
# noise against itself (x + d dt with dt ~ -700), so f32 rounding of
# 700-sized values (~4e-5) reaches the unit-sized result
SAMPLE_RTOL = 1e-3
T, H, W = 3, 32, 32


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module")
def engines():
    jcfg = JEngineConfig.tiny(num_frames=T, num_steps=2)
    jeng = JEngine(jcfg)
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, H, W), jax.random.PRNGKey(0)), 11)
    cfg = EngineConfig.tiny(num_frames=T, num_steps=2)
    peng = VideoDiffusionEngine(cfg, "cpu")
    PW.load_state_dicts(peng, PCV.engine_params_from_jax(params, cfg))
    rng = np.random.default_rng(12)
    guide = rng.uniform(-1, 1, size=(T, H, W, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, size=(1, H, W, 3)).astype(np.float32)
    return jeng, params, peng, guide, cond


def test_guidance_encode_and_conditioning(engines):
    jeng, params, peng, guide, cond = engines
    # the encoder works per frame: the port's chunks of 2 against the JAX
    # engine's whole-window encode (the shape its sample() uses)
    want = jeng.encode_images(params, jnp.asarray(guide))
    got = peng.encode_images_chunked(torch.tensor(guide), chunk=2)
    assert rel_err(got.numpy(), want) <= RTOL
    jc, juc = jeng.build_conditioning(params, jnp.asarray(cond))
    pc, puc = peng.build_conditioning(torch.tensor(cond))
    for j, p in ((jc, pc), (juc, puc)):
        for name in ("crossattn", "vector", "concat"):
            a, b = np.asarray(getattr(j, name)), getattr(p, name).numpy()
            assert a.shape == b.shape, name
            assert rel_err(b, a) <= RTOL or np.abs(a).max() == \
                np.abs(b).max() == 0, name


@pytest.mark.parametrize("sds", [False, True])
def test_sample_with_the_same_noise(engines, sds):
    """A whole sample (guidance encode, conditioning, the CFG denoiser,
    Euler or the SDS partial denoise, decode, clip) with the JAX sample's
    own noise; without SDS also with the port's sequential CFG (two T-frame
    passes, the same math as the JAX batch doubling) and low_vram (the VAE
    and CLIP on the host during the loop: the same result)."""
    jeng, params, peng, guide, cond = engines
    key = jax.random.PRNGKey(4)
    render = np.clip(guide[::-1] * 0.5, -1, 1).copy()
    kw = dict(render_images=jnp.asarray(render), sds_scale=0.5) if sds else {}
    want = np.asarray(jeng.sample(params, key, jnp.asarray(guide),
                                  jnp.asarray(cond), **kw))
    noise = np.asarray(jax.random.normal(key, (T, H // 2, W // 2, 4)))
    pkw = dict(render_images=torch.tensor(render), sds_scale=0.5) \
        if sds else {}
    got = peng.sample(torch.tensor(guide), torch.tensor(cond),
                      noise=torch.tensor(noise), **pkw).numpy()
    assert got.shape == want.shape == (T, H, W, 3)
    assert rel_err(got, want) <= SAMPLE_RTOL
    if not sds:
        seq = copy.copy(peng)
        seq.cfg = dataclasses.replace(peng.cfg, cfg_sequential=True)
        assert rel_err(seq.sample(torch.tensor(guide), torch.tensor(cond),
                                  noise=torch.tensor(noise)).numpy(),
                       want) <= SAMPLE_RTOL
        lv = copy.copy(peng)
        lv.cfg = dataclasses.replace(peng.cfg, low_vram=True)
        again = lv.sample(torch.tensor(guide), torch.tensor(cond),
                          noise=torch.tensor(noise)).numpy()
        np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("n,chunk,overlap", [(7, 4, 3), (6, 4, 2)])
def test_chunked_decode(engines, n, chunk, overlap):
    jeng, params, peng, _, _ = engines
    z = np.random.default_rng(n).normal(
        size=(n, H // 2, W // 2, 4)).astype(np.float32)
    want = jeng.decode_latents_chunked(params, jnp.asarray(z), chunk=chunk,
                                       overlap=overlap)
    got = peng.decode_latents_chunked(torch.tensor(z), chunk=chunk,
                                      overlap=overlap)
    assert got.shape == want.shape == (n, H, W, 3)
    assert rel_err(got.numpy(), want) <= RTOL


def test_engine_from_config_and_unported_options():
    dcfg = Config(dict(sample_frames=25, num_steps=2, cfg_scale=2.5,
                       fps_id=10, motion_bucket_id=127, cond_aug=0.0))
    assert PW.engine_from_config(dcfg).unet.fused_temporal is True
    assert PW.engine_from_config(dcfg, training=True).unet.fused_temporal \
        is False
    assert PW.engine_from_config(dcfg).unet.dtype == "bfloat16"
    from street_crafter_tpu_torch.models.vdm.layers import Downsample
    from street_crafter_tpu_torch.models.vdm.unet import UNetConfig, VideoUNet
    # quant_convs (the W8A8 eval path) builds, reached through UNetConfig
    # alone: engine_from_config never sets it
    assert PW.engine_from_config(dcfg).unet.quant_convs is False
    with torch.device("meta"):
        unet = VideoUNet(dataclasses.replace(UNetConfig.tiny(),
                                             quant_convs=True))
    assert unet.cfg.quant_convs
    assert isinstance(unet.input_blocks[3][0], Downsample)
    assert unet.input_blocks[3][0].quant_convs
    assert unet.input_blocks[1][0].quant_convs
    assert not unet.input_blocks[1][0].time_stack.quant_convs


# ----------------------------------------------------------- checkpoints


def _vwm_state_dict(peng) -> dict[str, np.ndarray]:
    sd = {}
    for part, prefix in (("unet", PCV.UNET_PREFIX), ("vae", PCV.VAE_PREFIX),
                         ("clip", PCV.CLIP_VISUAL_PREFIX)):
        for k, v in peng.modules()[part].state_dict().items():
            sd[prefix + k] = v.float().numpy().copy()
    return sd


def test_read_checkpoint_merge_and_duplicate(tmp_path, engines):
    rng = np.random.default_rng(14)
    base = "model.diffusion_model.input_blocks.1.1.transformer_blocks.0"
    sd = {f"{base}.attn1.to_q.weight": rng.normal(size=(6, 4)),
          f"{base}.attn1.q_adapter_down.weight": rng.normal(size=(2, 4)),
          f"{base}.attn1.q_adapter_up.weight": rng.normal(size=(6, 2)),
          f"{base}.attn1.to_out.0.weight": rng.normal(size=(4, 6)),
          f"{base}.attn1.out_adapter_down.weight": rng.normal(size=(2, 6)),
          f"{base}.attn1.out_adapter_up.weight": rng.normal(size=(4, 2)),
          "model.diffusion_model.time_embed.0.weight": rng.normal(size=(3,)),
          "model_ema.diffusion_modeltime_embed0weight": rng.normal(size=(3,)),
          "model_ema.decay": np.array(0.999)}
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    tsd = {k: torch.tensor(v) for k, v in sd.items()}
    paths = {"a.ckpt": {"state_dict": tsd},
             "b.bin": {"_forward_module." + k: v for k, v in tsd.items()},
             "c.pt": tsd}
    for name, obj in paths.items():
        torch.save(obj, tmp_path / name)
    from safetensors.numpy import save_file
    save_file(sd, str(tmp_path / "d.safetensors"))
    for name in list(paths) + ["d.safetensors"]:
        want = JCV.read_checkpoint(tmp_path / name)
        got = PCV.read_checkpoint(tmp_path / name)
        assert sorted(got) == sorted(want) == sorted(sd), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    want = JCV.duplicate_time_embed(JCV.merge_lora_ema(sd))
    got = PCV.duplicate_time_embed(PCV.merge_lora_ema(sd))
    assert sorted(got) == sorted(want)
    assert "model.diffusion_model.cond_time_stack_embed.0.weight" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_load_vdm_params_from_checkpoints(tmp_path, engines):
    """A vanilla-SVD-style vwm checkpoint (no cond_time_stack_embed) and the
    port's own format load into a fresh engine; the random init fills
    everything from a seed."""
    _, _, peng, _, _ = engines
    sd = {k: v for k, v in _vwm_state_dict(peng).items()
          if "cond_time_stack_embed" not in k}
    sd["conditioner.embedders.1.other.weight"] = np.zeros(2, np.float32)
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in sd.items()}},
               tmp_path / "vwm.ckpt")
    PW.save_vdm_params(str(tmp_path / "port.pt"), peng)
    for name in ("vwm.ckpt", "port.pt"):
        fresh = VideoDiffusionEngine(peng.cfg, "cpu")
        PW.load_vdm_params(fresh, Config(ckpt_path=str(tmp_path / name)))
        for part, m in fresh.modules().items():
            want = peng.modules()[part].state_dict()
            for k, v in m.state_dict().items():
                if name == "vwm.ckpt" and k.startswith(
                        "cond_time_stack_embed"):
                    ref = want[k.replace("cond_time_stack_embed",
                                         "time_embed")]
                else:
                    ref = want[k]
                torch.testing.assert_close(v, ref, rtol=0, atol=0)
    a = VideoDiffusionEngine(peng.cfg, "cpu")
    b = VideoDiffusionEngine(peng.cfg, "cpu")
    for e in (a, b):
        PW.load_vdm_params(e, Config(ckpt_path=""))
    for part in ("unet", "vae", "clip"):
        for (k, x), y in zip(a.modules()[part].state_dict().items(),
                             b.modules()[part].state_dict().values()):
            assert torch.equal(x, y) and bool(torch.isfinite(x).all()), k
    assert float(a.unet.out[2].weight.abs().max()) == 0.0   # zero init
    with pytest.raises(NotImplementedError):
        PW.load_vdm_params(a, Config(ckpt_path=str(tmp_path)))


# ------------------------------------------------------- runner.vdm_sample


def _synthetic_clip_root(root: str, frames: int = 26) -> str:
    """A synthetic scene with stand-in LiDAR condition renders (the camera
    image at a sparse mask) and its meta_info_val.json."""
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.utils.png import read_png, write_png
    scene = make_scene(root, num_frames=frames, img_hw=(64, 96))
    rng = np.random.default_rng(0)
    out = os.path.join(scene, "lidar", "color_render")
    for f in range(frames):
        img = read_png(os.path.join(scene, "images", f"{f:06d}_0.png"))
        mask = rng.random(img.shape[:2]) < 0.1
        write_png(os.path.join(out, f"{f:06d}_0.png"),
                  (img[..., :3] * mask[..., None]).astype(np.uint8))
        write_png(os.path.join(out, f"{f:06d}_0_mask.png"),
                  (mask * 255).astype(np.uint8))
    prepare_meta(root, [os.path.basename(scene)], "meta_info_val.json")
    return root


def test_vdm_sample_main_writes_pngs(tmp_path):
    from street_crafter_tpu_torch.runner import vdm_sample
    from street_crafter_tpu_torch.utils.png import read_png
    root = _synthetic_clip_root(str(tmp_path / "data"))
    cfg = {"device": "cpu", "model_path": str(tmp_path / "out"),
           "diffusion": {"tiny": True, "num_steps": 2},
           "vdm_train": {"data_root": root, "height": 32, "width": 48,
                         "num_frames": 3},
           "render": {"save_video": False}}
    path = tmp_path / "cfg.json"
    import json
    path.write_text(json.dumps(cfg))
    res = vdm_sample.main(["--config", str(path)])
    assert len(res["clips"]) == 1
    pngs = sorted(os.listdir(res["clips"][0]))
    assert len(pngs) == 3
    for name in pngs:
        img = read_png(os.path.join(res["clips"][0], name))
        assert img.shape == (3 * 32, 48, 3)
    assert np.isfinite(res["frames"]).all()
    assert np.abs(res["frames"]).max() <= 1.0
    # shard_sample on one process (no group of ranks) samples as without
    # it; on two ranks see tests/test_torch_sample_mesh.py
    one = vdm_sample.main(["--config", str(path),
                           "diffusion.shard_sample=true"])
    np.testing.assert_array_equal(one["frames"], res["frames"])


@pytest.mark.parametrize("diffusion", [{"compute_dtype": None},
                                       {"compute_dtype": "float32"},
                                       {"tiny": True},
                                       {"compute_dtype": "float16"}])
def test_build_engine_refuses_non_bf16_on_cuda(diffusion, monkeypatch):
    """The sampler builds bf16 and f32 engines on cuda (kernels D, G and H
    have both forms): compute dtype null, float32 and the tiny engine pass
    the check, float16 is refused before the engine is built. The engine's
    construction is stubbed, so no card is needed."""
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.runner import vdm_sample
    built = []

    def engine(ecfg, device):
        built.append((ecfg, torch.device(device)))
        return "engine"
    monkeypatch.setattr(vdm_sample, "VideoDiffusionEngine", engine)
    monkeypatch.setattr(vdm_sample, "load_vdm_params", lambda e, d: None)
    cfg = default_config()
    cfg.device = "cuda"
    for k, v in diffusion.items():
        cfg.diffusion[k] = v
    if diffusion.get("compute_dtype") == "float16":
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            vdm_sample.build_engine(cfg, 3)
        assert not built
        return
    assert vdm_sample.build_engine(cfg, 3) == "engine"
    (ecfg, dev), = built
    assert dev.type == "cuda" and ecfg.num_frames == 3
    assert {c.dtype for c in (ecfg.unet, ecfg.vae, ecfg.clip)} <= \
        {"float32", None}


def test_sample_rollout_conditions_on_the_overlap(engines):
    """Two windows of T = 3 over 5 frames: the second starts at frame 2 and
    is conditioned on all three frames the first produced there."""
    from street_crafter_tpu_torch.runner.vdm_sample import sample_rollout
    _, _, peng, guide, cond = engines
    frames = np.concatenate([guide, guide[:2]])
    calls = []
    orig = peng.sample

    def spy(*a, **kw):
        calls.append((kw["guide_images"].shape[0], kw["cond_indices"],
                      kw["cond_image"].shape[0]))
        return orig(*a, **kw)

    peng.sample = spy
    try:
        out = sample_rollout(peng, torch.Generator().manual_seed(0), frames,
                             cond[0], overlap=3)
    finally:
        del peng.sample
    assert calls == [(3, (0,), 1), (3, (0, 1, 2), 3)]
    assert out.shape == frames.shape
    assert np.isfinite(out).all() and np.abs(out).max() <= 1.0

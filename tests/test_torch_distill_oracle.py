"""The distillation mechanism through the port (street_crafter_tpu_torch:
``runner.train.train(diffusion_hook=)``, the hook's slot that
``make_diffusion_hook`` fills), with the sampler replaced by a ground-truth
novel-view oracle: JAX's tests/test_distillation_oracle.py on the port.

The oracle is the palette-coloured scene (the scene's own geometry,
recoloured by a smooth position palette at high opacity) rendered at the
diffusion-resolution novel cameras: what a perfect LiDAR-conditioned
diffusion model would sample. Everything but the sampler runs as in
production: the novel pool refresh, the diffusion_version bump, the
is_novel loss branch at the reference's weights (with the seeded
random-feature LPIPS stand-in, since the novel loss is LPIPS-dominant).
Training with the oracle's supervision must beat GS-only training on
held-out novel-view PSNR at equal iterations, by the JAX test's margin
(0.3 dB). The JAX package measured +1.45 dB (20.51 against 19.06,
BASELINE.md:152). Marked slow, as JAX's is.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

DH, DW = 64, 128   # the diffusion / novel-view resolution (= the scene's)
ITERS = 150


def palette(xyz: np.ndarray) -> np.ndarray:
    """Smooth position -> colour map (scripts/run_onchip_e2e.py)."""
    f = np.array([[0.37, 0.11, 0.23],
                  [0.05, 0.41, 0.17],
                  [0.19, 0.07, 0.31]], np.float32)
    return 0.5 + 0.45 * np.sin(np.asarray(xyz, np.float32) @ f.T)


def palette_gt_params(scene):
    """The scene's parameters recoloured by ``palette`` at opacity logit 3
    (``run_onchip_e2e.palette_gt_params`` on the port's pools)."""
    from street_crafter_tpu_torch.ops.sh import rgb_to_sh

    def recolor(pool):
        if pool is None:
            return None
        xyz = pool.xyz.detach().cpu().numpy().reshape(-1, 3)
        fdc = rgb_to_sh(torch.tensor(palette(xyz))).reshape(
            tuple(pool.xyz.shape[:-1]) + (1, 3)).to(pool.features_dc)
        if pool.features_dc.shape[-2] > 1:     # Fourier DC: coefficient 0
            fdc = torch.cat([fdc, torch.zeros(
                tuple(pool.features_dc.shape[:-2])
                + (pool.features_dc.shape[-2] - 1, 3))], -2)
        return dataclasses.replace(
            pool, features_dc=fdc,
            features_rest=torch.zeros_like(pool.features_rest),
            opacity=torch.full_like(pool.opacity, 3.0))

    p = scene.params
    return dataclasses.replace(p, bkgd=recolor(p.bkgd),
                               actors=recolor(p.actors), sky=recolor(p.sky))


def _render(scene, params, info, cam, sh_degree: int) -> np.ndarray:
    from street_crafter_tpu_torch.models.gs.renderer import render_scene
    b = scene.batch_for(info)
    with torch.no_grad():
        img = render_scene(params, scene.meta, cam,
                           frame_idx=b["frame_idx"], frame=b["frame"],
                           cam_id=b["cam_id"], timestamp=b.get("timestamp"),
                           sh_degree=sh_degree, clamp=True)["rgb"]
    return img.cpu().numpy()


def write_gt_images(cfg) -> None:
    """Palette GT of every train / test camera, written over its image."""
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.png import write_png
    scene = create_scene(cfg)
    gt = palette_gt_params(scene)
    infos = scene.info.train_cameras + scene.info.test_cameras
    for info, cam in zip(infos, scene.train_cameras + scene.test_cameras):
        img = _render(scene, gt, info, cam, cfg.model.gaussian.sh_degree)
        write_png(info.image_path,
                  np.clip(img * 255.0, 0, 255).astype(np.uint8))


def novel_gt(scene) -> list:
    """The oracle: palette GT at the diffusion-resolution novel cameras."""
    from street_crafter_tpu_torch.runner.diffusion import diffusion_camera
    gt = palette_gt_params(scene)
    return [_render(scene, gt, info, diffusion_camera(info, DH, DW), 1)
            for info in scene.info.novel_view_cameras]


def novel_psnr(scene, params, gt_imgs) -> float:
    from street_crafter_tpu_torch.runner.diffusion import diffusion_camera
    ps = []
    for info, gt in zip(scene.info.novel_view_cameras, gt_imgs):
        img = _render(scene, params, info, diffusion_camera(info, DH, DW), 1)
        mse = float(np.mean((img - gt) ** 2))
        ps.append(10.0 * np.log10(1.0 / max(mse, 1e-12)))
    return float(np.mean(ps))


def base_cfg(root: str, scene_dir: str, name: str):
    from street_crafter_tpu_torch.config import default_config
    c = default_config()
    c.device = "cpu"
    c.source_path = scene_dir
    c.model_path = os.path.join(root, name)
    c.data.cameras = [0]
    c.data.split_test = 2
    c.train.iterations = ITERS
    c.train.test_iterations = []
    c.train.checkpoint_iterations = []
    c.train.save_iterations = []
    c.train.log_interval = 1000
    c.train.novel_view_prob = 0.0
    c.optim.capacity_bkgd = 2048
    c.optim.capacity_obj = 256
    c.optim.capacity_sky = 512
    c.optim.densify_from_iter = 100000   # fixed pools: isolate supervision
    c.optim.opacity_reset_interval = 100000
    c.render.novel_view.shift = [2.0]
    c.model.gaussian.sh_degree = 1
    # the novel-view loss is LPIPS-dominant (lambda_novel_lpips 1.0 against
    # 0.1 for l1 / dssim): the seeded random-feature stand-in
    c.optim.lpips_fallback = "random_features"
    return c


def jax_stand_in(path: str):
    """The JAX package's LPIPS stand-in (its random filters, from
    jax.random at seed 0, as its trainer draws them) in the port's npz
    format, loaded by the port."""
    import jax
    from street_crafter_tpu.ops.lpips import random_lpips_params
    from street_crafter_tpu_torch.ops.lpips import load_lpips
    np.savez(path, **{k: np.asarray(v) for k, v in random_lpips_params(
        jax.random.PRNGKey(0)).items()})
    return load_lpips(path)


@pytest.mark.slow
@pytest.mark.parametrize("stand_in", ["port", "jax"])
def test_novel_view_supervision_beats_gs_only(tmp_path, stand_in):
    """With the port's LPIPS stand-in (``optim.lpips_fallback``) and with
    the JAX package's (the same objective as JAX's test)."""
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from street_crafter_tpu_torch.runner.train import train
    torch.manual_seed(0)
    root = str(tmp_path)
    scene_dir = make_scene(root, num_frames=4, img_hw=(DH, DW))
    write_gt_images(base_cfg(root, scene_dir, "gt_setup"))
    lpips_fn = (jax_stand_in(os.path.join(root, "lpips.npz"))
                if stand_in == "jax" else None)

    # run A: GS only
    trainer_a = train(base_cfg(root, scene_dir, "model_gs_only"),
                      lpips_fn=lpips_fn)
    gt = novel_gt(trainer_a.scene)
    psnr_a = novel_psnr(trainer_a.scene, trainer_a.state.params, gt)

    # run B: novel-view supervision from the oracle, through the hook's slot
    cb = base_cfg(root, scene_dir, "model_oracle")
    cb.train.novel_view_prob = 0.4      # the reference default
    cb.diffusion.use_diffusion = True   # the sampling schedule
    cb.diffusion.height = DH
    cb.diffusion.width = DW
    cb.diffusion.sample_iterations = [5]
    cb.diffusion.sds_scales = [0.7]
    events = []

    def oracle_hook(trainer, iteration, scale):
        scene = trainer.scene
        for info, img in zip(scene.info.novel_view_cameras, novel_gt(scene)):
            info._image = img
            info.metadata["diffusion_version"] = \
                info.metadata.get("diffusion_version", 0) + 1
        events.append(iteration)

    trainer_b = train(cb, diffusion_hook=oracle_hook, lpips_fn=lpips_fn)
    psnr_b = novel_psnr(trainer_b.scene, trainer_b.state.params, gt)
    print(f"{stand_in} LPIPS stand-in: novel-view PSNR: gs_only "
          f"{psnr_a:.2f} dB, oracle-supervised "
          f"{psnr_b:.2f} dB ({psnr_b - psnr_a:+.2f} dB at {ITERS} "
          f"iterations; the JAX package: +1.45 dB)")
    assert events == [5]
    assert psnr_b > psnr_a + 0.3, (psnr_a, psnr_b)

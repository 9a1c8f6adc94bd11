"""Port parity for the depth-reprojection warp (``ops/warp.py``) and the
render entry point's ``virtual_warp`` mode, against the JAX package on the
CPU.

- The warp op on tests/test_virtual_warp.py's five cases (identity warp,
  lateral translation over a plane, the occlusion test, the batch against
  one view, ``process_depth``): the port and JAX on the same inputs, rgb
  and depth to WARP_ATOL, masks equal.
- ``runner.render.main(mode=virtual_warp)`` end to end on the tiny 64x48
  scene from a JAX train state carried across (the JAX runner renders
  from its own checkpoint, the port from the converted one): the same
  files; source images equal; renders within 1 in uint8 (the raster's
  bound, tests/test_torch_render.py); masks equal except at pixels whose
  depth test sits within MARGIN of its threshold, |d - z| / (0.1 z) in
  [1 - MARGIN, 1 + MARGIN]: the rasters' depths differ by up to ~1e-3
  relative, so those pixels may flip. Their count is printed and must stay
  under MAX_FLIPS of all target pixels; the warped images within 1 in
  uint8 wherever both masks hold.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.torch_port_helpers import jax_scene_from_numpy, jax_tree_to_numpy

torch.set_num_threads(1)

H, W = 32, 48
K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
WARP_ATOL = 1e-6
MARGIN = 1e-3
MAX_FLIPS = 0.01
STEPS, SHIFT, YAW = 5, 2.0, 0.1


def _ramp():
    x = np.arange(W, dtype=np.float32)[None, :].repeat(H, 0)
    return np.stack([x / W, 0.5 * x / W, 1 - x / W], -1)


def _translated(t):
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = t
    return m


def _case(name):
    """(single-view arguments, or batched ones for "batched") of
    tests/test_virtual_warp.py's cases."""
    eye = np.eye(4, dtype=np.float32)
    depth = np.full((H, W), 5.0, np.float32)
    if name == "identity":
        return K, eye, depth, K, eye, depth, _ramp()
    if name == "lateral_translation":
        return K, _translated(0.5), depth, K, eye, depth, _ramp()
    if name == "occlusion":
        return K, eye, depth, K, eye, depth / 2, _ramp()
    tar = np.stack([eye, _translated(0.3)])
    return (np.broadcast_to(K, (2, 3, 3)), tar,
            np.broadcast_to(depth, (2, H, W)), np.broadcast_to(K, (2, 3, 3)),
            np.broadcast_to(eye, (2, 4, 4)), np.broadcast_to(depth, (2, H, W)),
            np.broadcast_to(_ramp(), (2, H, W, 3)))


@pytest.mark.parametrize("name", ["identity", "lateral_translation",
                                  "occlusion", "batched"])
def test_warp_matches_jax(name):
    import jax.numpy as jnp

    from street_crafter_tpu.ops import warp as J
    from street_crafter_tpu_torch.ops import warp as P
    args = _case(name)
    jfn, pfn = ((J.virtual_warp_images, P.virtual_warp_images)
                if name == "batched" else
                (J.virtual_warp_single, P.virtual_warp_single))
    want = jfn(*(jnp.asarray(np.ascontiguousarray(a)) for a in args))
    got = pfn(*(torch.tensor(np.ascontiguousarray(a)) for a in args))
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                               atol=WARP_ATOL, rtol=0)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=WARP_ATOL, rtol=0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    m = got.mask.numpy()
    if name == "identity":
        assert m.all()
    elif name == "lateral_translation":
        assert m.any() and not m.all()
    elif name == "occlusion":
        assert not m.any() and not got.rgb.numpy().any()
    else:
        one = P.virtual_warp_single(*(torch.tensor(np.ascontiguousarray(a[1]))
                                      for a in args))
        assert torch.equal(got.rgb[1], one.rgb)
        assert torch.equal(got.mask[1], one.mask)


def test_process_depth_matches_jax():
    import jax.numpy as jnp

    from street_crafter_tpu.ops.warp import process_depth as j_pd
    from street_crafter_tpu_torch.ops.warp import process_depth
    depth = np.array([[1.0, 2000.0], [3.0, 0.5]], np.float32)
    acc = np.array([[1.0, 1.0], [0.0, 0.5]], np.float32)
    got = process_depth(torch.tensor(depth), torch.tensor(acc)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pd(jnp.asarray(depth),
                                                       jnp.asarray(acc))))
    np.testing.assert_allclose(got, [[1.0, 900.0], [903.0, 450.5]])


def _warp_config(cfg, scene_dir, model_path):
    cfg.source_path = scene_dir
    cfg.model_path = model_path
    cfg.data.cameras = [0, 1]
    cfg.data.split_test = 2
    cfg.optim.capacity_bkgd = 2048
    cfg.optim.capacity_obj = 256
    cfg.optim.capacity_sky = 1024
    nv = cfg.render.novel_view
    nv.shift, nv.steps, nv.rotate = [SHIFT], STEPS, YAW
    return cfg


def test_virtual_warp_mode_matches_jax(tmp_path, monkeypatch):
    from street_crafter_tpu.config import default_config as j_default
    from street_crafter_tpu.runner import create_scene as j_scene
    from street_crafter_tpu.runner import render as JR
    from street_crafter_tpu.training.gs_trainer import init_train_state
    from street_crafter_tpu.utils.checkpoint import save_checkpoint as j_save
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.models.gs.convert import params_from_dict
    from street_crafter_tpu_torch.runner.render import main
    from street_crafter_tpu_torch.utils.checkpoint import save_checkpoint
    from street_crafter_tpu_torch.utils.png import read_png

    scene_dir = make_scene(str(tmp_path / "data"), num_frames=3)
    jcfg = _warp_config(j_default(), scene_dir, str(tmp_path / "jax"))
    jscene = j_scene(jcfg)
    # the scene init's opacities (0.1): no pixel's transmittance reaches the
    # port's stop rule, so both rasters composite every splat. The
    # grid-initialised actor stacks splats at equal depth, whose order the
    # port's stable sort and JAX's top_k break differently: jittered, as
    # tests/test_torch_train.py does
    params = jax_tree_to_numpy(jscene.params)
    xyz = params["actors"]["xyz"]
    params["actors"]["xyz"] = (xyz + np.random.default_rng(0).normal(
        0, 1e-3, xyz.shape)).astype(np.float32)
    jp, _ = jax_scene_from_numpy(params, None)
    j_save(jcfg.model_path, 3, init_train_state(jp))
    n = sum(int(np.prod(params[k]["valid"].shape))
            for k in ("bkgd", "actors", "sky"))
    jcfg.render.max_intersects_per_tile = n
    jcfg.render.max_intersects_per_coarse = n
    jcfg.render.auto_capacity = False
    # the JAX eval render with its exact selection, as the parity tests of
    # the render slice hold it (tests/test_torch_render.py)
    monkeypatch.setattr(JR, "make_eval_render", functools.partial(
        JR.make_eval_render, select_method="exact"))
    jout = JR.render_virtual_warp(jcfg)

    pcfg = _warp_config(default_config(), scene_dir, str(tmp_path / "port"))
    pcfg.device = "cpu"
    shutil.copytree(os.path.join(jcfg.model_path, "input_ply"),
                    os.path.join(pcfg.model_path, "input_ply"))
    save_checkpoint(pcfg.model_path, 3, params_from_dict(params))
    path = str(tmp_path / "port.json")
    save_config(pcfg, path)
    # the port's warp calls, and each target pixel's depth-test ratio
    # |d - z| / (0.1 z): the same warp with the source depth as its image
    # and no depth test samples d
    from street_crafter_tpu_torch.ops import warp as PW
    ratios = []
    orig = PW.virtual_warp_images

    def recorded(tK, tc2w, td, sK, sc2w, sd, srgb, depth_thresh=0.1):
        probe = orig(tK, tc2w, td, sK, sc2w, sd,
                     sd[..., None].expand(*sd.shape, 3),
                     depth_thresh=float("inf"))
        z = probe.depth
        ratios.append(((probe.rgb[..., 0] - z).abs() / (0.1 * z)).numpy())
        return orig(tK, tc2w, td, sK, sc2w, sd, srgb,
                    depth_thresh=depth_thresh)
    monkeypatch.setattr(PW, "virtual_warp_images", recorded)
    pout = main(["--config", path, "mode=virtual_warp"])
    assert sorted(pout["out_dirs"]) == sorted(jout)
    assert len(pout["view_ms"]) == len(jout) >= 2

    flips = total = d_render = d_cond = 0
    names = sorted(pout["out_dirs"], key=list(pout["out_dirs"]).index)
    assert len(ratios) == len(names)
    for image_name, ratio in zip(names, ratios):
        jdir = jout[image_name]
        pdir = pout["out_dirs"][image_name]
        files = sorted(os.listdir(jdir))
        assert sorted(os.listdir(pdir)) == files
        assert len(files) == 3 * STEPS

        def pair(f):
            return (read_png(os.path.join(pdir, f)).astype(int),
                    read_png(os.path.join(jdir, f)).astype(int))

        for f in ("0000.png", "0000_condition.png", "0000_mask.png"):
            a, b = pair(f)
            np.testing.assert_array_equal(a, b, err_msg=f)
        for i in range(1, STEPS):
            a, b = pair(f"{i:04d}.png")
            assert a.shape == (48, 64, 3)
            assert np.abs(a - b).max() <= 1, (image_name, i)
            d_render = max(d_render, int(np.abs(a - b).max()))
            ma, mb = pair(f"{i:04d}_mask.png")
            assert set(np.unique(ma)) <= {0, 255}
            differ = (ma != mb)[..., 0] if ma.ndim == 3 else ma != mb
            near = np.abs(ratio[i - 1] - 1.0) <= MARGIN
            assert not (differ & ~near).any(), (image_name, i,
                                                ratio[i - 1][differ])
            flips += int(differ.sum())
            total += differ.size
            ca, cb = pair(f"{i:04d}_condition.png")
            both = (ma > 0) & (mb > 0)
            assert both.any() and (~both).any(), (image_name, i)
            assert np.abs(ca - cb)[both].max() <= 1, (image_name, i)
            d_cond = max(d_cond, int(np.abs(ca - cb)[both].max()))
    print(f"virtual_warp masks: {flips} of {total} target pixels differ "
          f"(limit {MAX_FLIPS:.0%}); renders within {d_render}, warps "
          f"within {d_cond} in uint8")
    assert flips <= MAX_FLIPS * total

"""Port parity and end to end for the render slice of street_crafter_tpu_torch:
``render_scene`` against the JAX package's exact XLA render on the same
weights, the render entry point from a port checkpoint, the no-jax import
contract, and the host pieces it needs (PNG io, config, checkpoint).
"""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.torch_port_helpers import jax_scene_from_numpy, jax_tree_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_capacities(cfg):
    cfg.data.cameras = [0, 1]
    cfg.data.split_test = 2
    cfg.optim.capacity_bkgd = 2048
    cfg.optim.capacity_obj = 256
    cfg.optim.capacity_sky = 1024
    cfg.render.novel_view.shift = [2.0]
    return cfg


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("torch_render")),
                      num_frames=3)


@pytest.fixture(scope="module")
def jax_scene(scene_dir):
    """The JAX package's scene, with trained-looking random leaves: SH rest,
    opacities, track residuals, colour and pose corrections."""
    from street_crafter_tpu.config import default_config
    from street_crafter_tpu.runner import create_scene
    cfg = small_capacities(default_config())
    cfg.source_path = scene_dir
    cfg.model_path = os.path.join(os.path.dirname(scene_dir), "jax_model")
    cfg.model.nsg.opt_track = True
    cfg.model.use_color_correction = True
    cfg.model.use_pose_correction = True
    scene = create_scene(cfg)
    params = jax_tree_to_numpy(scene.params)
    rng = np.random.default_rng(0)
    for name in ("bkgd", "actors", "sky"):
        pool = params[name]
        pool["features_rest"] = rng.normal(
            0, 0.2, pool["features_rest"].shape).astype(np.float32)
        pool["opacity"] = rng.normal(
            0, 1.5, pool["opacity"].shape).astype(np.float32)
    for name, scale in (("opt_trans", 0.05), ("opt_theta", 0.05),
                        ("pose_corr_trans", 0.02)):
        params[name] = rng.normal(0, scale, params[name].shape).astype(
            np.float32)
    params["color_corr"] = (params["color_corr"] + rng.normal(
        0, 0.05, params["color_corr"].shape)).astype(np.float32)
    meta = jax_tree_to_numpy(scene.meta)
    return scene, params, meta


@pytest.mark.parametrize("which", [0, 3, 5])
def test_render_scene_matches_jax(jax_scene, which):
    import jax.numpy as jnp

    from street_crafter_tpu.models.gs.renderer import render_scene as j_render
    from street_crafter_tpu_torch.datasets.cameras import Camera
    from street_crafter_tpu_torch.models.gs.convert import scene_from_numpy
    from street_crafter_tpu_torch.models.gs.renderer import render_scene
    scene, params, meta = jax_scene
    jp, jm = jax_scene_from_numpy(params, meta)
    tp, tm = scene_from_numpy(params, meta)
    infos = scene.info.train_cameras + scene.info.test_cameras
    cams = scene.train_cameras + scene.test_cameras
    info, jcam = infos[which], cams[which]
    batch = scene.batch_for(info)
    n = sum(int(np.prod(p["valid"].shape)) for p in
            (params["bkgd"], params["actors"], params["sky"]))
    kw = dict(sh_degree=3, interpolate_pose=True, clamp=True)
    ref = j_render(jp, jm, jcam, frame_idx=batch["frame_idx"],
                   frame=batch["frame"], cam_id=batch["cam_id"],
                   timestamp=batch["timestamp"],
                   image_idx=batch["image_idx"], method="xla",
                   select_method="exact", max_per_tile=n, max_per_coarse=n,
                   **kw)
    tcam = Camera.from_extrinsic(np.asarray(jcam.w2c), np.asarray(jcam.K),
                                 jcam.width, jcam.height)
    out = render_scene(tp, tm, tcam, frame_idx=int(batch["frame_idx"]),
                       frame=float(batch["frame"]),
                       cam_id=int(batch["cam_id"]),
                       timestamp=float(batch["timestamp"]),
                       image_idx=int(batch["image_idx"]), **kw)
    acc = np.asarray(ref["acc"])
    # every part is on screen: background, the posed actor, the sky pass
    assert acc.mean() > 0.3 and float(jnp.max(ref["acc_sky"])) > 0.3
    assert np.asarray(ref["visibility"]).sum() > 100
    # rgb and acc: the raster's bound (T at the stop, <= 1e-3 for these
    # opacities, see test_torch_raster.py) plus the sky blend and the
    # colour correction on top of it
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(ref["rgb"]),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(out["acc"].numpy(), acc, atol=2e-3, rtol=0)
    np.testing.assert_allclose(out["acc_sky"].numpy(),
                               np.asarray(ref["acc_sky"]), atol=2e-3, rtol=0)
    m = acc > 0.5    # depth is divided by acc: compare where it is solid
    np.testing.assert_allclose(out["depth"].numpy()[m],
                               np.asarray(ref["depth"])[m], rtol=5e-3)
    np.testing.assert_array_equal(out["visibility"].numpy(),
                                  np.asarray(ref["visibility"]))
    np.testing.assert_allclose(out["radii"].numpy(), np.asarray(ref["radii"]),
                               atol=0, rtol=0)


def test_reader_and_scene_init_match_jax(jax_scene, scene_dir, tmp_path,
                                         monkeypatch):
    """The copied readers parse the same SceneInfo; initialize_ply writes the
    same plys as the JAX package's numpy path; build_scene_params builds
    the same pools from the same plys."""
    from street_crafter_tpu import native
    from street_crafter_tpu.data_processor import (
        get_pointcloud_processor as j_processor)
    from street_crafter_tpu.utils.ply import read_ply as j_read_ply
    from street_crafter_tpu_torch.data_processor import (
        get_pointcloud_processor)
    from street_crafter_tpu_torch.datasets.waymo import read_waymo_scene
    from street_crafter_tpu_torch.models.gs.build import build_scene_params
    from street_crafter_tpu_torch.utils.ply import read_ply
    scene, _, meta = jax_scene
    cfg = scene.cfg
    info = read_waymo_scene(scene_dir, cameras=[0, 1], split_test=2,
                            novel_view_shifts=[2.0], extent=cfg.data.extent)
    for a, b in ((info.train_cameras, scene.info.train_cameras),
                 (info.test_cameras, scene.info.test_cameras),
                 (info.novel_view_cameras, scene.info.novel_view_cameras)):
        assert [c.image_name for c in a] == [c.image_name for c in b]
        for ca, cb in zip(a, b):
            for f in ("R", "T", "K"):
                np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
            assert ca.metadata["timestamp"] == cb.metadata["timestamp"]
    np.testing.assert_array_equal(info.metadata["camera_tracklets"],
                                  scene.info.metadata["camera_tracklets"])

    # the JAX package's own numpy path (its optional C++ helper off), so
    # both sides run the same voxel and outlier arithmetic
    monkeypatch.setattr(native, "_native", None)
    frames = (0, info.metadata["num_frames"] - 1)
    j_paths = j_processor("waymo", scene_dir, cameras=[0, 1],
                          selected_frames=frames).initialize_ply(
        str(tmp_path / "jax"), scene.info.metadata["obj_meta"])
    t_paths = get_pointcloud_processor("waymo", scene_dir, cameras=[0, 1],
                                       selected_frames=frames).initialize_ply(
        str(tmp_path / "port"), info.metadata["obj_meta"])
    assert sorted(t_paths) == sorted(j_paths)
    assert {"lidar", "bkgd", "sky", "obj_000"} <= set(t_paths)
    for key in j_paths:
        a, b = read_ply(t_paths[key]), j_read_ply(j_paths[key])
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.colors, b.colors)

    params, tmeta = build_scene_params(scene.info, scene.ply_paths, cfg)
    for name in ("bkgd", "actors", "sky"):
        jp, tp = getattr(scene.params, name), getattr(params, name)
        for f in ("xyz", "features_dc", "features_rest", "rotation",
                  "opacity", "valid"):
            np.testing.assert_allclose(getattr(tp, f).numpy(),
                                       np.asarray(getattr(jp, f)), atol=1e-6)
        # log-scales from the knn. The JAX knn expands |x-y|^2 as
        # |x|^2+|y|^2-2xy in f32; with points ~13 m from the origin and
        # neighbours ~0.17 m apart that is off by up to ~2e-3 in log-scale
        # against float64, where the port's direct difference is within
        # 2e-7 (measured on this scene's background pool)
        np.testing.assert_allclose(tp.scaling.numpy(),
                                   np.asarray(jp.scaling), atol=5e-3)
    for f in ("opt_trans", "opt_theta", "color_corr", "pose_corr_quat",
              "pose_corr_trans"):
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(scene.params, f)))
    for f in ("track_trans", "track_quats", "track_valid", "timestamps",
              "actor_frame_range", "actor_bbox", "actor_random_init",
              "sphere_center"):
        np.testing.assert_array_equal(getattr(tmeta, f).numpy(), meta[f])
    assert float(tmeta.sphere_radius) == pytest.approx(
        float(meta["sphere_radius"]), rel=1e-6)


@pytest.fixture(scope="module")
def port_model(scene_dir, tmp_path_factory):
    """A port checkpoint of the port's own scene build, plus its config."""
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.checkpoint import save_checkpoint
    root = tmp_path_factory.mktemp("port_model")
    cfg = small_capacities(default_config())
    cfg.device = "cpu"
    cfg.source_path = scene_dir
    cfg.model_path = str(root / "model")
    scene = create_scene(cfg)
    assert scene.params.bkgd.num_valid() > 100
    assert scene.params.actors.xyz.shape[:2] == (1, 256)
    assert scene.params.sky.num_valid() > 100
    save_checkpoint(cfg.model_path, 7, scene.params)
    path = str(root / "scene.json")
    save_config(cfg, path)
    return cfg, path, scene


def test_render_main_trajectory(port_model):
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.runner.render import main
    from street_crafter_tpu_torch.utils.png import read_png
    cfg, path, scene = port_model
    G.reset_launch_counts()
    res = main(["--config", path, "mode=trajectory",
                "render.save_video=false"])
    n_cams = len(scene.info.train_cameras) + len(scene.info.test_cameras)
    assert res["out_dir"].endswith("trajectory_7")
    pngs = sorted(os.listdir(os.path.join(res["out_dir"], "rgb")))
    assert pngs == sorted(f"{i.metadata['frame']:06d}_"
                          f"{i.metadata['cam']}.png" for i in
                          scene.info.train_cameras + scene.info.test_cameras)
    assert len(pngs) == n_cams == 6
    img = read_png(os.path.join(res["out_dir"], "rgb", pngs[0]))
    assert img.shape == (48, 64, 3) and img.max() > 0
    for stream in ("acc", "depth", "gt", "diff"):
        assert len(os.listdir(os.path.join(res["out_dir"], stream))) == n_cams
    assert len(res["frame_ms"]) == n_cams and min(res["n_pairs"]) > 0
    assert np.isfinite(res["psnr"])
    assert res["videos"] == {}
    assert G.launches["tile_worklist_reference"] == 2 * n_cams  # fg + sky


def test_render_main_novel_view_and_unported_modes(port_model):
    from street_crafter_tpu_torch.runner.render import main
    cfg, path, scene = port_model
    res = main(["--config", path, "mode=novel_view",
                "render.save_video=false", "render.save_image=true"])
    assert len(res["out_dirs"]) == 1
    assert len(os.listdir(os.path.join(res["out_dirs"][0], "rgb"))) == \
        len(scene.info.novel_view_cameras)
    # modes diffusion and virtual_warp are ported (tests/test_torch_distill.py,
    # tests/test_torch_warp.py); a mode the entry point lacks still raises
    with pytest.raises(NotImplementedError, match="virtual_warp"):
        main(["--config", path, "mode=no_such_mode"])


def test_port_imports_no_jax():
    code = """
import sys
import numpy as np, torch
from street_crafter_tpu_torch.runner import render  # noqa: F401
from street_crafter_tpu_torch.datasets.cameras import Camera
from street_crafter_tpu_torch.models.gs.params import init_pool_from_points
from street_crafter_tpu_torch.models.gs.renderer import render_flat
from street_crafter_tpu_torch.models.gs.scene import FlatGaussians
rng = np.random.default_rng(0)
pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32); pts[:, 2] += 6
p = init_pool_from_points(pts, rng.uniform(size=(64, 3)), capacity=64)
flat = FlatGaussians(p.xyz, p.get_rotation(), p.get_scaling(),
                     p.get_opacity()[:, 0], p.get_features(), p.valid)
K = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
cam = Camera.from_c2w(np.eye(4), K, 32, 32)
out = render_flat(flat, cam.w2c, cam.K, cam.camera_center, 32, 32)
assert out["acc"].max() > 0.1
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


def _png_with_filters(img: np.ndarray, filters: list[int]) -> bytes:
    """Encode an RGB uint8 image with the given per-row PNG filter types."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        prev = a[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), a[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(left)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([f]) + ((a[y] - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_io(tmp_path):
    import imageio.v2 as imageio

    from street_crafter_tpu_torch.utils.png import read_png, write_png
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (5, 6), dtype=np.uint8)
    rgba = rng.integers(0, 256, (4, 3, 4), dtype=np.uint8)
    for i, img in enumerate((rgb, gray, rgba)):
        write_png(tmp_path / f"p{i}.png", img)
        np.testing.assert_array_equal(imageio.imread(tmp_path / f"p{i}.png"),
                                      img)
        imageio.imwrite(tmp_path / f"i{i}.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / f"i{i}.png"), img)
    (tmp_path / "f.png").write_bytes(_png_with_filters(rgb, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(read_png(tmp_path / "f.png"), rgb)
    with pytest.raises(ValueError):
        write_png(tmp_path / "x.png", rgb.astype(np.float32))


def test_config_and_checkpoint(tmp_path, rng):
    from street_crafter_tpu_torch.config import (default_config, load_config,
                                                 merge_dotlist, save_config)
    from street_crafter_tpu_torch.models.gs.params import init_pool_from_points
    from street_crafter_tpu_torch.models.gs.scene import SceneParams
    from street_crafter_tpu_torch.utils.checkpoint import (
        load_checkpoint, search_max_iteration, save_checkpoint)
    (tmp_path / "base.json").write_text(json.dumps(
        {"data": {"cameras": [0, 1]}, "render": {"fps": 5}}))
    (tmp_path / "child.json").write_text(json.dumps(
        {"parent_config": "base.json", "render": {"fps": 7}}))
    (tmp_path / "child.yaml").write_text(
        "parent_config: base.json\nrender:\n  fps: 9\n")
    cfg = default_config()
    cfg.merge(load_config(tmp_path / "child.json"))
    assert cfg.data.cameras == [0, 1] and cfg.render.fps == 7
    assert load_config(tmp_path / "child.yaml").render.fps == 9
    merge_dotlist(cfg, ["data.cameras=[0, 2]", "render.save_video=false",
                        "mode=novel_view", "x.y", "1.5", "z=null"])
    assert (cfg.data.cameras, cfg.render.save_video, cfg.mode, cfg.x.y,
            cfg.z) == ([0, 2], False, "novel_view", 1.5, None)
    save_config(cfg, tmp_path / "out.json")
    assert load_config(tmp_path / "out.json") == cfg

    pool = init_pool_from_points(rng.normal(size=(20, 3)),
                                 rng.uniform(size=(20, 3)), capacity=32)
    params = SceneParams(bkgd=pool, actors=None, sky=None, opt_trans=None,
                         opt_theta=None, sky_cubemap=None, color_corr=None,
                         color_corr_sky=None, pose_corr_quat=None,
                         pose_corr_trans=torch.zeros(3, 3))
    assert load_checkpoint(str(tmp_path)) == (None, None)
    save_checkpoint(str(tmp_path), 3, params)
    save_checkpoint(str(tmp_path), 12, params)
    assert search_max_iteration(str(tmp_path)) == 12
    restored, it = load_checkpoint(str(tmp_path))
    assert it == 12 and restored.actors is None
    assert restored.bkgd.capacity == 32
    for f in ("xyz", "scaling", "valid"):
        assert torch.equal(getattr(restored.bkgd, f), getattr(pool, f))
    assert torch.equal(restored.pose_corr_trans, torch.zeros(3, 3))

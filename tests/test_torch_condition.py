"""The port's LiDAR condition renders (``PointCloudProcessor.
render_condition`` on the CPU) against the JAX processor's, on one scene of
tests/synthetic_scene.make_scene copied once for each processor: the train
cameras and the 2 m lane-shift cameras, rgb and mask PNGs read back.

The JAX processor's splat has capacities (512 splats a 16-px tile, 4,096 a
128-px tile, approximate selection at recall 0.95) that bind on this scene:
it leaves whole tiles empty that the port's exact raster fills. So the PNGs
are held against the JAX processor with its splat through JAX's exact
raster without capacities (tests/test_torch_point_raster.py::
jax_gaussian_uncapped), and the JAX processor as it is only bounds the
port's masks from below. Tolerance: uint8 within 1 (the truncation to
uint8 of values equal to ~1e-6), plus, where the port's stop rule can act
(T <= 0.1, see tests/test_torch_point_raster.py), 255 T.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from street_crafter_tpu.data_processor import get_pointcloud_processor as J
from street_crafter_tpu.datasets.waymo import read_waymo_scene as j_read
from street_crafter_tpu.ops import point_raster as JP
from street_crafter_tpu_torch.data_processor import \
    get_pointcloud_processor as P
from street_crafter_tpu_torch.datasets.waymo import read_waymo_scene as p_read
from street_crafter_tpu_torch.ops import gs_raster as G
from street_crafter_tpu_torch.utils.png import read_png
from tests.synthetic_scene import make_scene
from tests.test_torch_point_raster import jax_gaussian_uncapped

KEYS = ("guidance_rgb_path", "guidance_mask_path")


def uncapped(c2w, K, points, colors, H, W, scale=0.01, use_ndc_scale=True,
             mask=None):
    rgb, acc, depth = jax_gaussian_uncapped(c2w, K, points, colors, H, W,
                                            scale, use_ndc_scale, mask)
    return JP.PointRenderOutput(jnp.asarray(rgb), jnp.asarray(acc),
                                jnp.asarray(depth))


def cameras(info):
    return info.train_cameras + info.novel_view_cameras


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    root = tmp_path_factory.mktemp("condition")
    src = make_scene(str(root / "src"), num_frames=3)
    dirs = {}
    for name in ("port", "jax", "jax_capped"):
        dirs[name] = str(root / name / "016")
        shutil.copytree(src, dirs[name])
    kw = dict(cameras=[0], novel_view_shifts=[2.0])
    infos = {"port": p_read(dirs["port"], **kw)}
    for name in ("jax", "jax_capped"):
        infos[name] = j_read(dirs[name], **kw)
    G.reset_launch_counts()
    proc = P("waymo", dirs["port"], cameras=[0], delta_frames=10,
             device="cpu")
    proc.render_conditions(cameras(infos["port"]),
                           infos["port"].metadata["obj_meta"])
    counts = dict(G.launches)
    J("waymo", dirs["jax_capped"], cameras=[0], delta_frames=10
      ).render_conditions(cameras(infos["jax_capped"]),
                          infos["jax_capped"].metadata["obj_meta"])
    mp = pytest.MonkeyPatch()
    mp.setattr(JP, "render_pointcloud_gaussian", uncapped)
    try:
        J("waymo", dirs["jax"], cameras=[0], delta_frames=10
          ).render_conditions(cameras(infos["jax"]),
                              infos["jax"].metadata["obj_meta"])
    finally:
        mp.undo()
    return infos, counts, proc


def pngs(info, cam_index, key):
    return read_png(cameras(info)[cam_index].metadata[key]).astype(np.int64)


def test_condition_pngs_match_jax(renders):
    infos, counts, _ = renders
    n = len(cameras(infos["port"]))
    assert n == 6      # 3 train views, 3 lane-shifted ones
    # one plain worklist and composite per camera, on the CPU
    assert counts == {"tile_worklist_reference": n, "composite_reference": n}
    for i in range(n):
        mask = pngs(infos["port"], i, KEYS[1])
        T = 1.0 - mask / 255.0
        # T from the truncated mask is at most 1/255 above the true T
        bound = 1 + np.where(T <= 0.1 + 1 / 255, 255 * T, 0.0)
        assert 0.2 < (mask > 0).mean() < 0.9
        for key in KEYS:
            got, want = pngs(infos["port"], i, key), pngs(infos["jax"], i,
                                                          key)
            assert got.shape == want.shape
            d = np.abs(got - want)
            if d.ndim == 3:
                d = d.max(-1)
            assert (d <= bound).all(), (i, key, int((d - bound).max()))
            assert (d <= 1).mean() > 0.99, (i, key)
            print(f"camera {i} {key}: max {d.max()}, share within 1 "
                  f"{(d <= 1).mean():.4f}")


def test_jax_capacities_only_drop(renders):
    """JAX's own processor (capped) covers no pixel that the port leaves
    uncovered: its drops only remove splats."""
    infos, _, _ = renders
    dropped = []
    for i in range(len(cameras(infos["port"]))):
        got = pngs(infos["port"], i, KEYS[1])
        want = pngs(infos["jax_capped"], i, KEYS[1])
        T = 1.0 - got / 255.0
        assert (got >= want - 1
                - 255 * np.where(T <= 0.1 + 1 / 255, T, 0.0)).all()
        dropped.append(float((want < got - 1).mean()))
    print(f"share of pixels whose mask JAX's capped render leaves lower: "
          f"{dropped}")
    # the capacities bind on this scene: the comparison above is not empty
    assert max(dropped) > 0.05, dropped


def test_render_condition_skips_existing(renders):
    infos, _, proc = renders
    cam = infos["port"].train_cameras[0]
    path = cam.metadata[KEYS[0]]
    before = os.stat(path).st_mtime_ns
    os.utime(path, ns=(before - 10 ** 9, before - 10 ** 9))
    proc.render_condition(cam, infos["port"].metadata["obj_meta"])
    assert os.stat(path).st_mtime_ns == before - 10 ** 9
    proc.render_condition(cam, infos["port"].metadata["obj_meta"],
                          force=True)
    assert os.stat(path).st_mtime_ns != before - 10 ** 9
    # the splat is Gaussian: soft edges, a mask in [0, 1]
    rgb, acc = proc._splat(np.concatenate(
        [proc.ply_dict["background"][0]]), cam, 0.01, True)
    assert rgb.shape == (cam.height, cam.width, 3)
    assert acc.min() >= 0 and acc.max() <= 1
    assert ((acc > 0) & (acc < 1)).any()
    assert torch.device("cpu") == proc.device


def test_render_lidar_cli_matches_jax(tmp_path):
    """The offline CLI (every frame, lane shifts 0 and 2 m, the
    camera-synced boxes at shift 0) against JAX's render_lidar with the
    uncapped splat, to the tolerance above."""
    from street_crafter_tpu.data_processor.render_lidar import \
        render_scene_conditions as j_render
    from street_crafter_tpu_torch.data_processor.render_lidar import main
    src = make_scene(str(tmp_path / "src"), num_frames=3)
    for name in ("port", "jax"):
        shutil.copytree(src, str(tmp_path / name / "016"))
    written = main(["--root", str(tmp_path / "port"), "--scenes", "016",
                    "--shifts", "0", "2", "--device", "cpu"])
    assert len(written) == 6
    mp = pytest.MonkeyPatch()
    mp.setattr(JP, "render_pointcloud_gaussian", uncapped)
    try:
        j_render(str(tmp_path / "jax" / "016"), cams=[0], shifts=[0.0, 2.0],
                 save_video_preview=False)
    finally:
        mp.undo()
    for path in written:
        for suffix in ("", "_mask"):
            p = path[:-4] + suffix + ".png"
            got = read_png(p).astype(np.int64)
            want = read_png(p.replace(str(tmp_path / "port"),
                                      str(tmp_path / "jax"))).astype(np.int64)
            mask = read_png(path[:-4] + "_mask.png").astype(np.int64)
            T = 1.0 - mask / 255.0
            bound = 1 + np.where(T <= 0.1 + 1 / 255, 255 * T, 0.0)
            d = np.abs(got - want)
            if d.ndim == 3:
                d = d.max(-1)
            assert (d <= bound).all() and (d <= 1).mean() > 0.99, p
    base = read_png(written[0]).astype(float)
    shifted = read_png(written[3]).astype(float)
    assert np.abs(base - shifted).mean() > 0.5

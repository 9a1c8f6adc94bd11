"""Port parity for the COLMAP input and the comparison images of
street_crafter_tpu_torch, against the JAX package on the CPU.

- ``utils/colmap_io``: binary models (points3D, cameras, images, written
  here) read exactly alike; the text model written by each package is the
  same bytes, and each package reads the other's points; with points, the
  port's text model reads back exactly.
- ``data_processor.colmap_driver``: ``load_colmap_points`` exactly equal
  (binary and text models, and None without one); ``run_colmap`` with the
  COLMAP runner injected on both sides (JAX's module-level ``_colmap``
  patched): the same command lists (paths relative to the output dir) and
  the same written files (images, inverted dynamic masks, the known-pose
  model, the rig config).
- Scene init with ``data.use_colmap``: the same input PLYs as the JAX
  package's, COLMAP points merged into the background; no model and no
  binary raises, as in JAX.
- ``data_processor.colmap_convert``: the commands and the moved files, and
  the image pyramid, equal to JAX's.
- ``visualizers/compare``: tests/test_compare_viz.py's cases, equal to
  JAX's outputs.
"""

import json
import os
import shutil
import sqlite3
import struct

import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene

torch.set_num_threads(1)

TRI = ("colmap", "triangulated", "sparse", "model")


def _points(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-10, 10, (n, 3)),
            rng.integers(0, 256, (n, 3)).astype(np.uint8),
            rng.uniform(0, 2, n))


def _write_binary_model(d, pts):
    """points3D.bin (with tracks), cameras.bin (a PINHOLE and an OPENCV
    camera) and images.bin (with 2D points), COLMAP's binary layout."""
    os.makedirs(d, exist_ok=True)
    xyz, rgb, err = pts
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i], *rgb[i],
                                err[i]))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 1, 0, 2, 5))
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))
        f.write(struct.pack("<4d", 40.0, 41.0, 32.0, 24.0))
        f.write(struct.pack("<iiQQ", 2, 4, 1920, 1280))
        f.write(struct.pack("<8d", *np.linspace(0.5, 4.0, 8)))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        for iid, name in ((3, "cam_0/000000_0.png"), (7, "cam_1/a.png")):
            f.write(struct.pack("<I", iid))
            f.write(struct.pack("<4d", 0.9, 0.1, -0.3, 0.2))
            f.write(struct.pack("<3d", 1.0, -2.0, 0.5))
            f.write(struct.pack("<I", iid % 2 + 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddqddq", 1.5, 2.5, 4, 3.0, 1.0, -1))


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_binary_models_read_alike(tmp_path):
    from street_crafter_tpu.utils import colmap_io as J
    from street_crafter_tpu_torch.utils import colmap_io as P
    pts = _points()
    d = str(tmp_path / "model")
    _write_binary_model(d, pts)
    for fn, name in (("read_points3D_binary", "points3D.bin"),
                     ("read_cameras_binary", "cameras.bin"),
                     ("read_images_binary", "images.bin")):
        path = os.path.join(d, name)
        _equal(getattr(P, fn)(path), getattr(J, fn)(path), fn)
    xyz, rgb, err = P.read_points3D_binary(os.path.join(d, "points3D.bin"))
    np.testing.assert_array_equal(xyz, pts[0])
    np.testing.assert_array_equal(rgb, pts[1])
    np.testing.assert_array_equal(err, pts[2])
    _equal(P.read_model_points(d), J.read_model_points(d))


def _text_model_inputs():
    rng = np.random.default_rng(1)
    cameras = {0: {"model": "SIMPLE_PINHOLE", "width": 64, "height": 48,
                   "params": [40.0, 32.0, 24.0]},
               3: {"model": "PINHOLE", "width": 1920, "height": 1280,
                   "params": [1100.5, 1101.25, 960.0, 640.0]}}
    images = {}
    for i in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = rng.normal(size=3) * 5
        images[i + 1] = {"name": f"cam_{i % 2}/{i:06d}_{i % 2}.png",
                         "camera_id": 0 if i % 2 == 0 else 3, "w2c": w2c}
    return cameras, images


def test_text_models_written_and_read_alike(tmp_path):
    from street_crafter_tpu.utils import colmap_io as J
    from street_crafter_tpu_torch.utils import colmap_io as P
    cameras, images = _text_model_inputs()
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    J.write_text_model(jd, cameras, images)
    P.write_text_model(pd, cameras, images)
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(jd, name), "rb") as f:
            want = f.read()
        with open(os.path.join(pd, name), "rb") as f:
            assert f.read() == want, name
    for m in (np.eye(3), images[2]["w2c"][:3, :3]):
        np.testing.assert_array_equal(P.rotmat_to_qvec(m),
                                      J.rotmat_to_qvec(m))
    # each reads the other's (empty) points, then the port's with points
    _equal(P.read_model_points(jd), J.read_model_points(pd))
    pts = _points(seed=2)
    P.write_text_model(pd, cameras, images, points=pts)
    for got in (P.read_model_points(pd), J.read_model_points(pd)):
        for g, w in zip(got, pts):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["binary", "text", "none"])
def test_load_colmap_points_matches_jax(tmp_path, kind):
    from street_crafter_tpu.data_processor.colmap_driver import \
        load_colmap_points as j_load
    from street_crafter_tpu_torch.data_processor.colmap_driver import \
        load_colmap_points
    from street_crafter_tpu_torch.utils.colmap_io import write_text_model
    d = os.path.join(str(tmp_path), *TRI)
    pts = _points(seed=3)
    if kind == "binary":
        _write_binary_model(d, pts)
    elif kind == "text":
        write_text_model(d, {}, {}, points=pts)
    got, want = load_colmap_points(str(tmp_path)), j_load(str(tmp_path))
    if kind == "none":
        assert got is None and want is None
        return
    _equal(got, want)
    assert got[0].dtype == got[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], pts[1].astype(np.float32) / 255.0)


def _read_cameras(scene_dir):
    from street_crafter_tpu.datasets.waymo import read_waymo_scene as j_read
    from street_crafter_tpu_torch.datasets.waymo import read_waymo_scene
    kw = dict(cameras=[0, 1], split_test=2)
    return (read_waymo_scene(scene_dir, **kw).train_cameras,
            j_read(scene_dir, **kw).train_cameras)


class FakeColmap:
    """Records each command with the output dir's path replaced by
    ``<out>``; feature_extractor writes the database the driver reads (an
    image id per copied image, a camera per camera folder)."""

    def __init__(self, out_dir):
        self.out = os.path.abspath(out_dir)
        self.calls = []

    def __call__(self, args):
        args = list(args)
        self.calls.append([a.replace(self.out, "<out>") for a in args])
        if args[0] != "feature_extractor":
            return
        db = args[args.index("--database_path") + 1]
        images = args[args.index("--image_path") + 1]
        names = sorted(os.path.relpath(os.path.join(r, f), images)
                       for r, _, fs in os.walk(images) for f in fs)
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE cameras (camera_id INTEGER, params BLOB)")
        conn.execute("CREATE TABLE images (image_id INTEGER, name TEXT, "
                     "camera_id INTEGER)")
        folders = sorted({n.split("/")[0] for n in names})
        for cid in range(len(folders)):
            conn.execute("INSERT INTO cameras VALUES (?, ?)", (cid + 1, b""))
        for i, n in enumerate(names):
            conn.execute("INSERT INTO images VALUES (?, ?, ?)",
                         (i + 1, n, folders.index(n.split("/")[0]) + 1))
        conn.commit()
        conn.close()


def _tree(root):
    """{relative path: content} of every file: PNGs decoded, the database
    as its rows, the rest as bytes."""
    from street_crafter_tpu_torch.utils.png import read_png
    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(r, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".png"):
                out[rel] = read_png(p)
            elif f.endswith(".db"):
                conn = sqlite3.connect(p)
                out[rel] = (conn.execute("SELECT * FROM images").fetchall(),
                            conn.execute("SELECT * FROM cameras").fetchall())
                conn.close()
            else:
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_run_colmap_matches_jax(tmp_path, monkeypatch):
    from street_crafter_tpu.data_processor import colmap_driver as JD
    from street_crafter_tpu_torch.data_processor import colmap_driver as PD
    scene_dir = make_scene(str(tmp_path / "data"), num_frames=3)
    pcams, jcams = _read_cameras(scene_dir)
    assert any(os.path.exists(c.guidance.get("obj_bound_path", ""))
               for c in pcams)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jfake, pfake = FakeColmap(jout), FakeColmap(pout)
    monkeypatch.setattr(JD, "_colmap", lambda *a: jfake(a))
    jtri = JD.run_colmap(jcams, jout, use_rig_ba=True)
    ptri = PD.run_colmap(pcams, pout, use_rig_ba=True, runner=pfake)
    assert os.path.relpath(ptri, pout) == os.path.relpath(jtri, jout)
    assert pfake.calls == jfake.calls
    assert [c[0] for c in pfake.calls] == [
        "feature_extractor", "exhaustive_matcher", "point_triangulator",
        "rig_bundle_adjuster"]
    got, want = _tree(pout), _tree(jout)
    _equal(got, want)
    assert len([k for k in got if k.startswith("mask/")]) == len(pcams)
    assert json.loads(got["cam_rigid_config.json"])[0]["ref_camera_id"] == 0
    # without the binary, the default runner refuses with a clear error
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="colmap"):
        PD.run_colmap(pcams, str(tmp_path / "none"))


def _colmap_scene_config(cfg, scene_dir, model_path):
    cfg.source_path = scene_dir
    cfg.model_path = model_path
    cfg.data.cameras = [0, 1]
    cfg.data.split_test = 2
    cfg.data.use_colmap = True
    cfg.optim.capacity_bkgd = 4096
    cfg.optim.capacity_obj = 256
    cfg.optim.capacity_sky = 1024
    return cfg


def test_scene_init_with_colmap_matches_jax(tmp_path, monkeypatch):
    from street_crafter_tpu.config import default_config as j_default
    from street_crafter_tpu.runner import create_scene as j_scene
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.colmap_io import write_text_model
    from street_crafter_tpu_torch.utils.ply import read_ply
    scene_dir = make_scene(str(tmp_path / "data"), num_frames=3)
    rng = np.random.default_rng(4)
    pts = (rng.uniform([0, -8, 0], [20, 8, 4], (200, 3)),
           rng.integers(0, 256, (200, 3)).astype(np.uint8),
           rng.uniform(0, 1, 200))
    # the JAX package's own numpy path (its optional C++ helper off), so
    # both sides run the same voxel and outlier arithmetic
    from street_crafter_tpu import native
    monkeypatch.setattr(native, "_native", None)
    paths = {}
    for name in ("jax", "port"):
        model = str(tmp_path / name)
        write_text_model(os.path.join(model, *TRI), {}, {}, points=pts)
        paths[name] = os.path.join(model, "input_ply")
    j_scene(_colmap_scene_config(j_default(), scene_dir, str(tmp_path /
                                                             "jax")))
    pcfg = _colmap_scene_config(default_config(), scene_dir,
                                str(tmp_path / "port"))
    pcfg.device = "cpu"
    scene = create_scene(pcfg)
    names = sorted(os.listdir(paths["jax"]))
    assert sorted(os.listdir(paths["port"])) == names
    assert "points3D_colmap.ply" in names
    for name in names:
        got = read_ply(os.path.join(paths["port"], name))
        want = read_ply(os.path.join(paths["jax"], name))
        np.testing.assert_array_equal(got.points, want.points, err_msg=name)
        np.testing.assert_array_equal(got.colors, want.colors, err_msg=name)
    lidar = read_ply(os.path.join(paths["port"], "points3D_lidar.ply"))
    bkgd = read_ply(os.path.join(paths["port"], "points3D_bkgd.ply"))
    assert len(lidar.points) < len(bkgd.points)
    assert scene.params.bkgd.num_valid() == min(len(bkgd.points), 4096)
    # no model and no binary: the scene init raises, as JAX's does
    monkeypatch.setattr(shutil, "which", lambda name: None)
    pcfg.model_path = str(tmp_path / "empty")
    with pytest.raises(RuntimeError, match="colmap"):
        create_scene(pcfg)


def _convert_runner(sp, calls, image=None):
    def fake(args):
        calls.append([a.replace(str(sp), "<sp>") for a in args])
        if args[0] == "image_undistorter":
            (sp / "images").mkdir(exist_ok=True)
            (sp / "sparse").mkdir(exist_ok=True)
            for f in ("cameras.bin", "images.bin", "points3D.bin"):
                (sp / "sparse" / f).write_bytes(f.encode())
            if image is not None:
                from PIL import Image
                Image.fromarray(image).save(sp / "images" / "a.png")
    return fake


@pytest.mark.parametrize("opts", [{}, {"skip_matching": True},
                                  {"camera_model": "PINHOLE",
                                   "use_gpu": True},
                                  {"skip_matching": True, "resize": True}])
def test_colmap_convert_matches_jax(tmp_path, opts):
    from street_crafter_tpu.data_processor.colmap_convert import \
        convert_colmap_scene as j_convert
    from street_crafter_tpu_torch.data_processor.colmap_convert import \
        convert_colmap_scene
    image = np.random.default_rng(5).integers(0, 256, (37, 70, 3)).astype(
        np.uint8)
    out = {}
    for name, fn in (("jax", j_convert), ("port", convert_colmap_scene)):
        sp = tmp_path / name
        (sp / "input").mkdir(parents=True)
        calls = []
        assert fn(str(sp), runner=_convert_runner(sp, calls, image),
                  **opts) == str(sp)
        out[name] = (calls, _tree(str(sp)))
    _equal(out["port"], out["jax"])
    files = out["port"][1]
    assert sorted(k for k in files if k.startswith("sparse")) == [
        "sparse/0/cameras.bin", "sparse/0/images.bin",
        "sparse/0/points3D.bin"]
    if opts.get("resize"):
        for factor in (2, 4, 8):
            assert files[f"images_{factor}/a.png"].shape == (
                37 // factor, 70 // factor, 3)


# -- visualizers/compare ---------------------------------------------------------

def _compare_cases():
    rng = np.random.default_rng(0)
    front = np.full((16, 24, 3), 0.5, np.float32)
    side = np.full((12, 24, 3), 0.25, np.float32)
    img = np.ones((8, 8, 3), np.float32)
    corners = np.array([[[4, 4], [20, 4], [20, 20], [4, 20],
                         [8, 8], [24, 8], [24, 24], [8, 24]]])
    depth = rng.uniform(4.0, 80.0, size=(16, 16)).astype(np.float32)
    w = np.zeros(100)
    w[:10] = 1.0
    gt = np.full((16, 16, 3), 0.5, np.float32)
    return {
        "tile_waymo": ("tile_cameras", ([side, front, side], [
            "left_camera", "front_camera", "right_camera"], "waymo"), {}),
        "tile_nuscenes": ("tile_cameras", ([img, img], ["CAM_FRONT",
                                                        "CAM_BACK"],
                                           "nuscenes"), {}),
        "bbox": ("draw_bbox3d", (np.zeros((32, 32, 3), np.uint8), corners),
                 {"colors": (255, 0, 0), "thickness": 1}),
        "bbox_default": ("draw_bbox3d", (np.zeros((32, 32, 3), np.uint8),
                                         corners), {}),
        "color_for_id": ("color_for_id", ("track_001",), {}),
        "depth": ("visualize_depth", (depth, np.ones((16, 16), np.float32)),
                  {"lo": 4.0, "hi": 120.0}),
        "depth_percentile": ("visualize_depth", (depth, None), {}),
        "matte": ("checker_matte", (np.ones((16, 16, 3)),
                                    np.zeros((16, 16))), {}),
        "percentile": ("weighted_percentile",
                       (np.arange(100, dtype=np.float32), None, [10, 90]),
                       {}),
        "percentile_weighted": ("weighted_percentile",
                                (np.arange(100, dtype=np.float32), w, [90]),
                                {}),
        "strip": ("compare_strip", ({"gt": gt, "render": gt * 0.4,
                                     "diffusion": gt},), {}),
    }


@pytest.mark.parametrize("case", sorted(_compare_cases()))
def test_compare_matches_jax(case):
    from street_crafter_tpu.visualizers import compare as J
    from street_crafter_tpu_torch.visualizers import compare as P
    fn, args, kw = _compare_cases()[case]
    got, want = getattr(P, fn)(*args, **kw), getattr(J, fn)(*args, **kw)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if case == "tile_waymo":
        assert got.shape == (16, 24 * 5, 3) and got[:4, :24].max() == 0.0


def test_compare_rejects_unknown_dataset():
    from street_crafter_tpu_torch.visualizers import compare as P
    with pytest.raises(ValueError):
        P.tile_cameras([np.ones((8, 8, 3))], ["x"], "nope")

"""The port's host-side data processors (street_crafter_tpu_torch.
data_processor.{range_images, waymo_converter, pandaset, sky_mask,
moge_pcd}, datasets.pandaset_layout and the synthetic builders) against the
JAX package's, on the CPU, from the same seeded numpy inputs.

Tolerances:
- range images: points within 1e-9 m of JAX's float64 numpy (both sides
  round the same float64 products; matrix products may sum in another
  order); colours, colour masks, the sparse depth maps (mask and values)
  and the in-box masks equal;
- the LiDAR frame core (``range_images.lidar_frame``) against the body of
  JAX's ``waymo_converter._convert_lidar``: float32 points within 1e-6 m,
  everything else equal; the WOD converter's stages through shared fake
  ``tf`` / ``dataset_pb2`` / ``frame_utils`` objects: the files each
  package writes equal (PLY points within 1e-6 m);
- PandaSet: loaders equal, ``get_obj_info`` (slerp in float32) within
  1e-6; condition PNGs against JAX's processor with its splat through
  JAX's uncapped exact raster, within 1 in uint8 plus 255 T where the
  port's stop rule can act (T <= 0.1; tests/test_torch_condition.py);
  ``prepare_meta`` equal;
- the heuristic sky mask bit-equal, wrap-around across column 0 included;
- MoGe: the weighted fit's (a, b) within 1e-6 relative of JAX's
  ``np.polyfit`` (which fits float32 inputs in float32 and returns float32
  coefficients; the port fits in float64, within 1e-9 of numpy's float64
  fit), 1e-4 for a fit over a 0.1-wide range that amplifies the rounding;
  the two resizes equal to JAX's PIL calls, the written PLYs within 1e-5
  m.
"""

import json
import os
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from street_crafter_tpu_torch.datasets.synthetic import make_wod_lidar_frame
from street_crafter_tpu_torch.utils.ply import read_ply
from street_crafter_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(1)

DEV = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- range images -------------------------------------------------------------

def _extrinsic(yaw=0.3, t=(1.0, 0.5, 2.0)):
    c, s = np.cos(yaw), np.sin(yaw)
    e = np.eye(4)
    e[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    e[:3, 3] = t
    return e


def _pose(rng):
    """A random rigid pose (rotation from a normalised quaternion)."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    p = np.eye(4)
    p[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)]]
    p[:3, 3] = rng.uniform(-5, 5, 3)
    return p


def test_range_image_round_trip_matches_jax():
    from street_crafter_tpu.data_processor import range_images as J
    from street_crafter_tpu_torch.data_processor import range_images as P
    rng = np.random.default_rng(0)
    H, W = 32, 256
    incl = np.linspace(0.3, -0.3, H)
    ext = _extrinsic()
    img = np.full((H, W), -1.0)
    img[rng.integers(0, H, 500), rng.integers(0, W, 500)] = \
        rng.uniform(2.0, 60.0, 500)
    want = J.range_image_to_cartesian(img, incl, ext)
    got = _np(P.range_image_to_cartesian(img, incl, ext, device=DEV))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    valid = img > 0
    back_j = J.cartesian_to_range_image(want[valid], incl, W, extrinsic=ext)
    back_p = _np(P.cartesian_to_range_image(got[valid], incl, W,
                                            extrinsic=ext, device=DEV))
    # the same cells; ranges within 1e-12 relative (the inverse pose's
    # products may sum in another order)
    np.testing.assert_array_equal(back_p > 0, back_j > 0)
    np.testing.assert_allclose(back_p, back_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(back_p[valid], img[valid], rtol=1e-6)
    # a cell hit twice: the last point wins, as numpy's assignment
    pts = np.concatenate([want[valid], want[valid][:5] * 1.01])
    np.testing.assert_allclose(
        _np(P.cartesian_to_range_image(pts, incl, W, extrinsic=ext,
                                       device=DEV)),
        J.cartesian_to_range_image(pts, incl, W, extrinsic=ext),
        rtol=1e-12, atol=0)


def test_range_image_pixel_pose_branch_matches_jax():
    from street_crafter_tpu.data_processor import range_images as J
    from street_crafter_tpu_torch.data_processor import range_images as P
    rng = np.random.default_rng(1)
    H, W = 8, 64
    incl = np.linspace(0.2, -0.2, H)
    ext = _extrinsic(0.7, (1.2, -0.3, 1.9))
    img = rng.uniform(2, 50, (H, W))
    pixel_pose = np.stack([_pose(rng) for _ in range(H * W)]).reshape(
        H, W, 4, 4)
    frame_inv = np.linalg.inv(_pose(rng))
    want = J.range_image_to_cartesian(img, incl, ext, pixel_pose=pixel_pose,
                                      frame_pose_inv=frame_inv)
    got = _np(P.range_image_to_cartesian(img, incl, ext,
                                         pixel_pose=pixel_pose,
                                         frame_pose_inv=frame_inv,
                                         device=DEV))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # the identity per-pixel pose changes nothing
    eye = np.broadcast_to(np.eye(4), (H, W, 4, 4)).copy()
    np.testing.assert_allclose(
        _np(P.range_image_to_cartesian(img, incl, ext, pixel_pose=eye,
                                       frame_pose_inv=np.eye(4),
                                       device=DEV)),
        _np(P.range_image_to_cartesian(img, incl, ext, device=DEV)),
        atol=1e-9)


def _cameras(rng, n=3, H=48, W=64):
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    opencv = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                       [0.0, -1.0, 0.0, 0.0], [0, 0, 0, 1.0]])
    images, intr, c2v = {}, {}, {}
    for c in range(n):
        images[c] = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        intr[c] = K
        c2v[c] = _extrinsic(0.6 * (c - 1), (1.0, 0.2 * c, 1.5)) @ opencv
    return images, intr, c2v


def test_colorize_depth_and_boxes_equal_jax():
    from street_crafter_tpu.data_processor import range_images as J
    from street_crafter_tpu_torch.data_processor import range_images as P
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-30, 30, (4000, 3)),
                          # many points on few pixels: the min must win
                          np.repeat(rng.uniform(5, 20, (20, 3)), 8, 0)
                          * rng.uniform(0.9, 1.1, (160, 1))])
    images, intr, c2v = _cameras(rng)
    want_rgb, want_mask = J.colorize_points(
        pts, {c: im / 255.0 for c, im in images.items()}, intr, c2v)
    got_rgb, got_mask = P.colorize_points(pts, images, intr, c2v,
                                          device=DEV)
    np.testing.assert_array_equal(_np(got_mask), want_mask)
    np.testing.assert_array_equal(_np(got_rgb), want_rgb)
    assert 0.1 < want_mask.mean() < 0.9
    for c in images:
        want_v, want_m = J.scatter_min_depth(pts, intr[c], c2v[c], 48, 64)
        got_v, got_m = P.scatter_min_depth(pts, intr[c], c2v[c], 48, 64,
                                           device=DEV)
        np.testing.assert_array_equal(_np(got_m), want_m)
        np.testing.assert_array_equal(_np(got_v), want_v)
        assert want_m.sum() > 100
    for heading in (0.0, 0.4, -2.5, np.pi / 2):
        ctr = rng.uniform(-10, 10, 3)
        lwh = rng.uniform(5, 20, 3)
        want = J.points_in_box(pts, ctr, heading, lwh, scale=1.2)
        got = _np(P.points_in_box(pts, ctr, heading, lwh, scale=1.2,
                                  device=DEV))
        np.testing.assert_array_equal(got, want)
        assert want.any()


def jax_convert_lidar_body(lidars, images, intrinsics, cam2vehicles, boxes):
    """The body of JAX's waymo_converter._convert_lidar on plain arrays,
    through JAX's range_images functions."""
    from street_crafter_tpu.data_processor import range_images as J
    pts = np.concatenate([
        J.range_image_to_cartesian(np.maximum(img, 0.0), incl, ext)[img > 0]
        for img, incl, ext in lidars])
    rgb, col = J.colorize_points(
        pts, {c: im / 255.0 for c, im in images.items()}, intrinsics,
        cam2vehicles)
    assigned = np.zeros(len(pts), bool)
    actors = {}
    for tid, box in boxes.items():
        ctr = np.array([box["center_x"], box["center_y"], box["center_z"]])
        inside = J.points_in_box(pts, ctr, box["heading"], np.array(
            [box["length"], box["width"], box["height"]]))
        inside &= ~assigned
        if inside.sum() == 0:
            continue
        assigned |= inside
        c, s = np.cos(box["heading"]), np.sin(box["heading"])
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        actors[tid] = (((pts[inside] - ctr) @ rot).astype(np.float32),
                       rgb[inside], col[inside])
    background = (pts[~assigned].astype(np.float32), rgb[~assigned],
                  col[~assigned])
    depth = {}
    for cam, im in images.items():
        value, mask = J.scatter_min_depth(pts, intrinsics[cam],
                                          cam2vehicles[cam], *im.shape[:2])
        depth[cam] = (mask, value)
    return background, actors, depth


def test_lidar_frame_matches_jax_convert_lidar():
    from street_crafter_tpu_torch.data_processor.range_images import \
        lidar_frame
    fr = make_wod_lidar_frame(seed=3, scale=0.2)
    want_bg, want_actors, want_depth = jax_convert_lidar_body(
        fr["lidars"], fr["images"], fr["intrinsics"], fr["cam2vehicles"],
        fr["boxes"])
    out = lidar_frame(fr["lidars"], fr["images"], fr["intrinsics"],
                      fr["cam2vehicles"], fr["boxes"], device=DEV)
    assert list(out.actors) == list(want_actors) and len(want_actors) >= 3

    def same(got, want):
        np.testing.assert_allclose(_np(got[0]), want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(_np(got[1]), want[1])
        np.testing.assert_array_equal(_np(got[2]), want[2])
    same(out.background, want_bg)
    for tid, want in want_actors.items():
        same(out.actors[tid], want)
    for cam, (mask, value) in want_depth.items():
        np.testing.assert_array_equal(_np(out.depth[cam][0]), mask)
        np.testing.assert_array_equal(_np(out.depth[cam][1]), value)
        assert mask.sum() > 50
    assert 0.1 < want_bg[2].mean() < 1.0


# -- the WOD converter through shared fakes -----------------------------------

LASER_TOP, N_FRAMES = 1, 2


class _Box(types.SimpleNamespace):
    def ByteSize(self):
        return 0 if getattr(self, "empty", False) else 1


def _fake_wod(seed: int = 4):
    """(tf, dataset_pb2, frame_utils) fakes over two frames built from
    ``make_wod_lidar_frame``: the calls the converters make, nothing else."""
    from street_crafter_tpu_torch.datasets.waymo_layout import CAMERA_NAMES
    rng = np.random.default_rng(seed)
    frames, jpegs = [], {}
    for fid in range(N_FRAMES):
        fr = make_wod_lidar_frame(seed=seed + fid, scale=0.1)
        ego = _pose(rng)
        images, cams = [], []
        for cam, img in fr["images"].items():
            key = f"jpeg_{fid}_{cam}"
            jpegs[key] = img
            K = fr["intrinsics"][cam]
            raw_c2v = fr["cam2vehicles"][cam] @ np.linalg.inv(np.array(
                [[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                 [0.0, -1.0, 0.0, 0.0], [0, 0, 0, 1.0]]))
            cams.append(types.SimpleNamespace(
                name=cam + 1, height=img.shape[0], width=img.shape[1],
                intrinsic=[K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.01, 0.0,
                           0.0, 0.0, 0.0],
                extrinsic=types.SimpleNamespace(
                    transform=raw_c2v.reshape(-1).tolist())))
            images.append(types.SimpleNamespace(
                name=cam + 1, image=key,
                pose=types.SimpleNamespace(
                    transform=(ego @ _pose(rng)).reshape(-1).tolist()),
                pose_timestamp=1.5 + 0.1 * fid + 0.01 * cam))
        lasers, range_images = [], {}
        for i, (r, incl, ext) in enumerate(fr["lidars"]):
            name = i + 1
            data = np.zeros(r.shape + (4,))
            data[..., 0] = r
            data[..., 1] = rng.uniform(0, 1, r.shape)     # intensity
            range_images[name] = [types.SimpleNamespace(
                data=data.reshape(-1).tolist(),
                shape=types.SimpleNamespace(dims=list(data.shape)))]
            explicit = name == LASER_TOP
            lasers.append(types.SimpleNamespace(
                name=name,
                extrinsic=types.SimpleNamespace(
                    transform=ext.reshape(-1).tolist()),
                beam_inclinations=list(incl[::-1]) if explicit else [],
                beam_inclination_min=float(incl[-1]),
                beam_inclination_max=float(incl[0])))
        labels, projected = [], {c: [] for c in range(5)}
        for k, (tid, box) in enumerate(fr["boxes"].items()):
            b = _Box(**{f: box[f] + (0.8 * fid if f == "center_x"
                                     and k % 2 else 0.0)
                        for f in ("center_x", "center_y", "center_z",
                                  "heading", "length", "width",
                                  "height")})
            synced = _Box(**vars(b), empty=k == 1)
            labels.append(types.SimpleNamespace(
                id=tid, type=k % 5, box=b, camera_synced_box=synced,
                metadata=types.SimpleNamespace(speed_x=0.5 * k,
                                               speed_y=-0.2)))
            for cam in range(5):
                projected[cam].append(types.SimpleNamespace(
                    id=f"{tid}_{CAMERA_NAMES[cam]}",
                    box=types.SimpleNamespace(
                        center_x=20.0 + 15 * k, center_y=12.0 + 3 * k,
                        width=10.0 + k, length=30.0)))
        frames.append(types.SimpleNamespace(
            pose=types.SimpleNamespace(transform=ego.reshape(-1).tolist()),
            timestamp_micros=1_500_000 + 100_000 * fid,
            images=images,
            context=types.SimpleNamespace(camera_calibrations=cams,
                                          laser_calibrations=lasers),
            laser_labels=labels,
            projected_lidar_labels=[types.SimpleNamespace(
                name=c + 1, labels=projected[c]) for c in range(5)],
            range_images=range_images))

    class Frame:
        def ParseFromString(self, data):
            self.__dict__.update(vars(frames[int(bytes(data))]))

    class Record:
        def __init__(self, i):
            self.i = i

        def numpy(self):
            return str(self.i).encode()

    class Decoded:
        def __init__(self, key):
            self.key = key

        def numpy(self):
            return jpegs[self.key]

    tf = types.SimpleNamespace(
        data=types.SimpleNamespace(
            TFRecordDataset=lambda path, compression_type="": [
                Record(i) for i in range(len(frames))]),
        io=types.SimpleNamespace(decode_jpeg=Decoded))
    dataset_pb2 = types.SimpleNamespace(Frame=Frame)
    frame_utils = types.SimpleNamespace(
        parse_range_image_and_camera_projection=lambda frame: (
            frame.range_images, {}, None, None))
    return tf, dataset_pb2, frame_utils


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def _same_file(a: str, b: str) -> None:
    ext = os.path.splitext(a)[1]
    if ext == ".txt":
        np.testing.assert_array_equal(np.loadtxt(a), np.loadtxt(b))
    elif ext == ".json":
        assert json.load(open(a)) == json.load(open(b))
    elif ext == ".pkl":
        _same_tree(pickle.load(open(a, "rb")), pickle.load(open(b, "rb")))
    elif ext == ".png":
        np.testing.assert_array_equal(read_png(a), read_png(b))
    elif ext == ".ply":
        pa, pb = read_ply(a), read_ply(b)
        np.testing.assert_allclose(pa.points, pb.points, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pa.colors, pb.colors)
        np.testing.assert_array_equal(pa.mask, pb.mask)
    elif ext == ".npz":
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    else:
        raise AssertionError(f"unexpected file {a}")


def _tree_files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_waymo_converter_stages_match_jax(tmp_path, monkeypatch):
    from street_crafter_tpu.data_processor import waymo_converter as J
    from street_crafter_tpu_torch.data_processor import waymo_converter as P
    fakes = _fake_wod()
    monkeypatch.setattr(J, "_import_wod", lambda: fakes)
    monkeypatch.setattr(P, "_import_wod", lambda: fakes)
    J.convert("seq.tfrecord", str(tmp_path / "jax"))
    P.convert("seq.tfrecord", str(tmp_path / "port"), device=DEV)
    files = _tree_files(str(tmp_path / "jax"))
    assert files == _tree_files(str(tmp_path / "port"))
    kinds = {os.path.dirname(f).split(os.sep)[0] for f in files}
    assert kinds >= {"images", "ego_pose", "intrinsics", "extrinsics",
                     "track", "dynamic_mask", "lidar"}
    assert sum(f.startswith(os.path.join("lidar", "actor")) for f in files) \
        >= 3
    for f in files:
        _same_file(str(tmp_path / "jax" / f), str(tmp_path / "port" / f))
    # the dynamic masks are not empty (moving actors are projected)
    m = read_png(str(tmp_path / "port" / "dynamic_mask" / "000000_0.png"))
    assert 0 < (m > 0).mean() < 1
    # the box dict: a protobuf box's fields, as JAX's
    box = _Box(height=1.0, width=2.0, length=3.0, center_x=4.0,
               center_y=5.0, center_z=6.0, heading=0.5)
    assert P._box_dict(box, "vehicle", 1.5, 0.1) == \
        J._box_dict(box, "vehicle", 1.5, 0.1)


def test_waymo_converter_gate_names_the_package(monkeypatch):
    from street_crafter_tpu_torch.data_processor import waymo_converter as P
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="waymo-open-dataset"):
        P._import_wod()
    with pytest.raises(ImportError, match="missing: tensorflow"):
        P.convert("seq.tfrecord", "/nonexistent", device=DEV)


# -- PandaSet -----------------------------------------------------------------

@pytest.fixture(scope="module")
def panda(tmp_path_factory):
    """One synthetic PandaSet scene (the port's builder, the JAX package's
    scene with 500-point sweeps), rendered by the port on the CPU and by
    JAX's processor with its splat through JAX's uncapped exact raster,
    shifts 0 and 2 m."""
    from street_crafter_tpu.data_processor import pandaset as JPS
    from street_crafter_tpu.ops import point_raster as JP
    from street_crafter_tpu_torch.data_processor import pandaset as PPS
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.datasets.synthetic import \
        make_pandaset_scene
    from tests.test_torch_condition import uncapped
    root = tmp_path_factory.mktemp("panda")
    src = make_pandaset_scene(str(root / "src"), num_frames=4, num_cams=2,
                              points_per_frame=500)
    dirs = {}
    for name in ("port", "jax"):
        dirs[name] = str(root / name / "001")
        shutil.copytree(src, dirs[name])
    G.reset_launch_counts()
    written = PPS.render_scene_conditions(dirs["port"], cams=[0],
                                          shifts=[0.0, 2.0], device=DEV)
    counts = dict(G.launches)
    mp = pytest.MonkeyPatch()
    mp.setattr(JP, "render_pointcloud_gaussian", uncapped)
    try:
        JPS.render_scene_conditions(dirs["jax"], cams=[0], shifts=[0.0, 2.0],
                                    save_video_preview=False)
    finally:
        mp.undo()
    return dirs, written, counts


def test_pandaset_layout_matches_jax(panda):
    from street_crafter_tpu.datasets import pandaset_layout as J
    from street_crafter_tpu_torch.datasets import pandaset_layout as P
    d = panda[0]["port"]
    jp, ji = J.load_camera_info(d)
    pp, pi = P.load_camera_info(d)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(np.stack(pi), np.stack(ji))
    assert pp.shape == (4, 2, 4, 4)
    assert P.load_track(d) == J.load_track(d)
    assert P.load_timestamps(d) == J.load_timestamps(d)
    _, info = P.load_track(d)
    ts = P.load_timestamps(d)["front_camera"]
    ann = info["0"]["frame_annotations"]
    for t in (0.0, 0.05, 0.15, 0.2999, 0.33, 0.38, 9.0, -0.05):
        want = J.get_obj_info(ann, ts, t)
        got = P.get_obj_info(ann, ts, t)
        if want is None:
            assert got is None
            continue
        np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-6)
        np.testing.assert_allclose(got["box"], want["box"], atol=1e-12)
    np.testing.assert_allclose(P.get_obj_info(ann, ts, 0.15)["pose"][1, 3],
                               0.75, atol=1e-5)
    # slerp between two rotated poses (the instance poses above are
    # translations only)
    rng = np.random.default_rng(5)
    a, b = _pose(rng), _pose(rng)
    for alpha in (0.0, 0.3, 0.77, 1.0):
        np.testing.assert_allclose(P.slerp_pose(a, b, alpha),
                                   J.slerp_pose(a, b, alpha), atol=1e-6)
    for f in range(4):
        np.testing.assert_array_equal(P.get_lane_shift_direction(pp, 0, f),
                                      J.get_lane_shift_direction(jp, 0, f))
    assert P.image_filename_to_frame("012_3.png") == 12
    assert P.image_filename_to_cam("012_3.png") == 3
    assert P.LANE_SHIFT_SIGN["011"] == 1 and P.LANE_SHIFT_SIGN["999"] == -1


def test_pandaset_clouds_match_jax(panda):
    from street_crafter_tpu.data_processor import pandaset as J
    from street_crafter_tpu.datasets import pandaset_layout as JL
    from street_crafter_tpu_torch.data_processor import pandaset as P
    lidar = os.path.join(panda[0]["port"], "lidar_forward")
    jd, pd = J.read_lidar_ply(lidar), P.read_lidar_ply(lidar)
    _same_tree(pd, jd)
    for start, end in ((0, 3), (1, 2), (3, 3)):
        _same_tree(P.make_lidar_ply(pd, start, end),
                   J.make_lidar_ply(jd, start, end))
    _, info = JL.load_track(panda[0]["port"])
    ts = JL.load_timestamps(panda[0]["port"])["front_camera"]
    obj = JL.get_obj_info(info["0"]["frame_annotations"], ts, 0.15)
    obj["pose"][:3, :3] = _pose(np.random.default_rng(6))[:3, :3]
    ply = np.concatenate([jd["0"][1], jd["0"][1] * 2.0])   # half outside
    want = J.pose_actor_ply(ply, obj)
    got = _np(P.pose_actor_ply(ply, obj, device=DEV))
    assert 0 < len(want) < len(ply)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_pandaset_condition_pngs_match_jax(panda):
    dirs, written, counts = panda
    assert len(written) == 8            # 4 frames x 2 shifts, camera 0
    assert counts == {"tile_worklist_reference": 8,
                      "composite_reference": 8}
    for tag in ("color_render", "color_render_shift_2.00"):
        for f in range(4):
            names = (f"{f:03d}_0.png", f"{f:03d}_0_mask.png")
            paths = {k: [os.path.join(d, "lidar_forward", tag, n)
                         for n in names] for k, d in dirs.items()}
            mask = read_png(paths["port"][1]).astype(np.int64)
            T = 1.0 - mask / 255.0
            bound = 1 + np.where(T <= 0.1 + 1 / 255, 255 * T, 0.0)
            assert (mask > 0).mean() > 0.03
            for got_p, want_p in zip(paths["port"], paths["jax"]):
                got = read_png(got_p).astype(np.int64)
                want = read_png(want_p).astype(np.int64)
                assert got.shape == want.shape
                d = np.abs(got - want)
                d = d.max(-1) if d.ndim == 3 else d
                assert (d <= bound).all(), (got_p, int((d - bound).max()))
                assert (d <= 1).mean() > 0.99, got_p
    a = read_png(os.path.join(dirs["port"], "lidar_forward", "color_render",
                              "001_0.png")).astype(float)
    b = read_png(os.path.join(dirs["port"], "lidar_forward",
                              "color_render_shift_2.00", "001_0.png"))
    assert np.abs(a - b).mean() > 0.5


def test_pandaset_skips_existing_and_prepare_meta_matches_jax(panda):
    from street_crafter_tpu.data_processor import pandaset as J
    from street_crafter_tpu_torch.data_processor import pandaset as P
    dirs = panda[0]
    assert P.render_scene_conditions(dirs["port"], cams=[0],
                                     shifts=[0.0, 2.0], device=DEV) == []
    for kw in (dict(num_frames=3, stride=1, shifts=[2.0]),
               dict(num_frames=2, stride=2, shifts=None),
               dict(num_frames=3, stride=1, cam=1)):
        outs = {}
        for name, mod in (("port", P), ("jax", J)):
            root = os.path.dirname(dirs[name])
            path = mod.prepare_meta(root, ["001"], save_name=f"m_{name}.json",
                                    **kw)
            outs[name] = json.load(open(path))
        assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == 0          # camera 1 has no renders
    root = os.path.dirname(dirs["port"])
    path = P.prepare_meta(root, ["001"], num_frames=3, stride=1,
                          shifts=[2.0])
    assert len(json.load(open(path))) == 2


def test_pandaset_builder_matches_jax(tmp_path):
    from street_crafter_tpu_torch.datasets.synthetic import \
        make_pandaset_scene
    from tests.synthetic_scene import make_pandaset_scene as jax_builder
    a = make_pandaset_scene(str(tmp_path / "port"), num_frames=3)
    b = jax_builder(str(tmp_path / "jax"), num_frames=3)
    files = _tree_files(a)
    assert files == _tree_files(b) and len(files) > 20
    for f in files:
        _same_file(os.path.join(a, f), os.path.join(b, f))


# -- sky masks ----------------------------------------------------------------

def _street(H=60, W=80, seed=0):
    img = np.zeros((H, W, 3), np.float32)
    img[: H // 3] = [0.7, 0.8, 0.95]
    img[H // 3:] = 0.3
    rng = np.random.default_rng(seed)
    img[H // 3:] += rng.uniform(-0.15, 0.15, (H - H // 3, W, 3))
    img[H // 2: H // 2 + 10, 10:25] = rng.uniform(0.5, 1.0, (10, 15, 3))
    return np.clip(img, 0, 1)


def _wrapping(H=40, W=50):
    """Sky that reaches the left side only across the image's right / left
    edge: the top row is bright near column W-1 only, the bright band below
    it spans columns W-6 .. W-1 and 0 .. 9 (a run through the wrap; its
    first row is no candidate, a step from the dark row above), a column
    hangs from it, and a block beside the column is reached from below
    only (the up sweeps)."""
    img = np.full((H, W, 3), 0.2, np.float32)
    img[0, W - 3:] = 0.9
    img[1:6, W - 6:] = 0.9
    img[1:6, :10] = 0.9
    img[6:20, 4:9] = 0.9         # reached through column 0's run
    img[12:16, 9:14] = 0.9       # a side pocket
    img[10:12, 12:14] = 0.9      # above the pocket: reached from below
    img[20:, :] += np.random.default_rng(1).uniform(0, 0.5, (H - 20, W, 1))
    return img


def test_heuristic_sky_mask_bit_equal_to_jax():
    from street_crafter_tpu.data_processor.sky_mask import \
        heuristic_sky_mask as J
    from street_crafter_tpu_torch.data_processor.sky_mask import \
        heuristic_sky_mask as P
    rng = np.random.default_rng(7)
    cases = [(_street(), {}), (_wrapping(), {}),
             (_street(33, 41, seed=2), dict(brightness_thresh=0.6,
                                            grad_thresh=0.1))]
    # smooth random fields: ragged regions, runs through the wrap
    for k in range(4):
        base = rng.uniform(0, 1, (9, 12, 3))
        img = np.kron(base, np.ones((4, 5, 1))).astype(np.float32)
        img += rng.normal(0, 0.01, img.shape).astype(np.float32)
        cases.append((np.clip(img, 0, 1), dict(brightness_thresh=0.4,
                                               grad_thresh=0.05 + 0.03 * k)))
    for img, kw in cases:
        want = J(img, **kw)
        got = _np(P(img, device=DEV, **kw))
        assert got.dtype == np.bool_ and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()
    want = J(cases[1][0])
    assert want[2:6, :10].all() and want[2:6, -5:].all()     # the wrap
    assert want[11, 13] and want[12, 12:14].all()            # the up sweep
    assert not want[11, :4].any()
    # a batch fills each image alone
    batch = np.stack([c[0] for c in cases[3:6]])
    np.testing.assert_array_equal(
        _np(P(batch, brightness_thresh=0.4, grad_thresh=0.08, device=DEV)),
        np.stack([J(im, brightness_thresh=0.4, grad_thresh=0.08)
                  for im in batch]))


def test_generate_scene_sky_masks_matches_jax(tmp_path):
    from street_crafter_tpu.data_processor.sky_mask import \
        generate_scene_sky_masks as J
    from street_crafter_tpu_torch.data_processor.sky_mask import \
        generate_scene_sky_masks as P
    for name in ("jax", "port"):
        img_dir = tmp_path / name / "images"
        os.makedirs(img_dir)
        write_png(str(img_dir / "000000_0.png"),
                  (_street() * 255).astype(np.uint8))
        write_png(str(img_dir / "000001_0.png"),
                  (_wrapping() * 255).astype(np.uint8))
        write_png(str(img_dir / "000000_3.png"),
                  (_street() * 255).astype(np.uint8))   # camera 3 skipped
    assert J(str(tmp_path / "jax"), cams=[0]) == 2
    assert P(str(tmp_path / "port"), cams=[0], device=DEV) == 2
    for f in ("000000_0.png", "000001_0.png"):
        got = read_png(str(tmp_path / "port" / "sky_mask" / f))
        np.testing.assert_array_equal(
            got, read_png(str(tmp_path / "jax" / "sky_mask" / f)))
        assert 0 < (got > 0).mean() < 1
    assert P(str(tmp_path / "port"), cams=[0], device=DEV) == 0


def _sam_fixtures(H, W, calls):
    def detect_fn(image, caption, box_th, text_th):
        calls.append((caption, box_th, text_th))
        return np.array([[0.25, 0.10, 0.5, 0.2], [0.75, 0.10, 0.5, 0.2],
                         [0.5, 0.80, 0.4, 0.2]], np.float32)

    def segment_fn(image, boxes_xyxy):
        calls.append(len(boxes_xyxy))
        masks = np.zeros((len(boxes_xyxy), H, W), bool)
        for i, (x0, y0, x1, y1) in enumerate(boxes_xyxy.astype(int)):
            masks[i, max(y0, 0):y1, max(x0, 0):x1] = True
        return masks
    return detect_fn, segment_fn


def test_sam_orchestration_matches_jax(tmp_path, monkeypatch):
    from street_crafter_tpu.data_processor import sky_mask as J
    from street_crafter_tpu_torch.data_processor import sky_mask as P
    H, W = 64, 96
    img = np.random.default_rng(8).integers(0, 255, (H, W, 3), np.uint8)
    for kw in (dict(box_threshold=0.35, top_edge_px=20), {},
               dict(top_edge_px=5)):
        jc, pc = [], []
        want = J.sam_sky_mask(img, *_sam_fixtures(H, W, jc), **kw)
        got = P.sam_sky_mask(img, *_sam_fixtures(H, W, pc), **kw)
        np.testing.assert_array_equal(got, want)
        assert pc == jc
    assert not P.sam_sky_mask(img, lambda *a: np.zeros((0, 4)),
                              None).any()
    # the scene driver: per-camera box thresholds
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name / "images")
        for c in (0, 1):
            write_png(str(tmp_path / name / "images" / f"000000_{c}.png"),
                      img)
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", J), ("port", P)):
        backend = _sam_fixtures(H, W, seen[name])
        assert mod.generate_scene_sky_masks(
            str(tmp_path / name), cams=(0, 1), method="sam",
            sam_backend=backend, box_thresholds=[0.4, 0.25]) == 2
    assert seen["port"] == seen["jax"]
    assert sorted(c[1] for c in seen["port"] if isinstance(c, tuple)) == \
        [0.25, 0.4]
    for c in (0, 1):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "port" / "sky_mask" / f"000000_{c}.png")),
            read_png(str(tmp_path / "jax" / "sky_mask" / f"000000_{c}.png")))
    # the real backend's gate names the missing package
    monkeypatch.setitem(sys.modules, "groundingdino", None)
    with pytest.raises(ImportError, match="groundingdino"):
        P.build_sam_backend("sam.pth")


# -- MoGe ---------------------------------------------------------------------

def test_recover_metric_depth_matches_jax():
    from street_crafter_tpu.data_processor.moge_pcd import \
        recover_metric_depth as J
    from street_crafter_tpu_torch.data_processor.moge_pcd import \
        recover_metric_depth as P
    rng = np.random.default_rng(9)
    pred = rng.uniform(1.0, 20.0, (40, 60)).astype(np.float32)
    gt = np.zeros_like(pred)
    m = rng.random(pred.shape) < 0.3
    gt[m] = 2.0 * pred[m] + 1.0 + rng.normal(0, 0.3, m.sum())
    valid = rng.random(pred.shape) < 0.8
    narrow = np.where(m & (pred > 19.9), gt, 0)   # x spans 0.1: ill-posed
    # (inputs, tolerance against JAX): JAX fits float32 inputs in float32
    # and rounds (a, b) to float32, the port fits in float64; the narrow
    # fit amplifies that rounding
    for args, rtol in (((pred, gt, None), 1e-6), ((pred, gt, valid), 1e-6),
                       ((pred, gt, np.zeros_like(valid)), 1e-6),
                       ((np.array([[1.0, 2.0, 3.0]]),        # slope < 0:
                         np.array([[6.0, 4.0, 2.0]]), None), 1e-12),
                       ((pred, narrow, None), 1e-4)):
        wa, ja, jb = J(*args)
        ga, pa, pb = P(*args, device=DEV)
        assert isinstance(pa, float) and isinstance(pb, float)
        np.testing.assert_allclose([pa, pb], [ja, jb], rtol=rtol, atol=1e-9)
        np.testing.assert_allclose(_np(ga), wa, rtol=rtol,
                                   atol=rtol * np.abs(wa).max())
        # against numpy's own fit of the same data in float64
        p, g, v = (np.asarray(a, np.float64) if a is not None else None
                   for a in args)
        sel = (g > 1e-8) & ((v > 0) if v is not None and v.any() else True)
        fa, fb = np.polyfit(p[sel], g[sel], 1, w=1.0 / g[sel])
        if fa > 0:
            np.testing.assert_allclose([pa, pb], [fa, fb], rtol=1e-9)


def test_moge_resizes_equal_jax_pil():
    from street_crafter_tpu.data_processor import moge_pcd as J
    from street_crafter_tpu_torch.data_processor import moge_pcd as P
    rng = np.random.default_rng(10)
    img = rng.uniform(-0.1, 1.1, (96, 128, 3)).astype(np.float32)
    for area in (40 * 30, 96 * 128, 200 * 150):
        np.testing.assert_array_equal(P._area_resize(img, area),
                                      J._area_resize(img, area))
    depth = rng.uniform(1, 80, (37, 51)).astype(np.float32)
    for shape in ((96, 128), (37, 51), (20, 30)):
        np.testing.assert_array_equal(
            P._bilinear_resize_depth(depth, shape),
            J._bilinear_resize_depth(depth, shape))


def _moge_predictor(scene_dir):
    """A seeded stand-in predictor of any input size: a depth ramp, and
    metric targets inside the moving actor's frame-0 box and far from it,
    divided by (2, 1) (the affine map the fit recovers)."""
    from street_crafter_tpu_torch.datasets import waymo_layout
    _, _, trajectory = waymo_layout.load_track(scene_dir)
    _, extrinsics, _, _ = waymo_layout.load_camera_info(scene_dir)
    ego2cam = np.linalg.inv(np.asarray(extrinsics[0]))
    traj = trajectory["actor_moving"]
    pose0 = np.asarray(traj["poses_vehicle"][0], np.float64)
    rng = np.random.default_rng(11)
    canon = rng.uniform(-0.4, 0.4, (30, 3)) * np.array(
        [traj["length"], traj["width"], traj["height"]])
    targets = np.concatenate([canon @ pose0[:3, :3].T + pose0[:3, 3],
                              rng.uniform(30.0, 60.0, (60, 3))])
    pred_pts = ((targets @ ego2cam[:3, :3].T + ego2cam[:3, 3]) - 1.0) / 2.0

    def predict(image, fov_x):
        h, w = image.shape[:2]
        ramp = 10.0 + 20.0 * (np.arange(w, dtype=np.float32) / w)
        pts = np.zeros((h, w, 3), np.float32)
        mask = np.zeros((h, w), bool)
        pts.reshape(-1, 3)[: len(pred_pts)] = pred_pts
        mask.reshape(-1)[: len(pred_pts)] = True
        mask.reshape(-1)[-5:] = True                  # a few stray points
        return {"points": pts, "mask": mask,
                "depth": (np.broadcast_to(ramp, (h, w)) - 1.0) / 2.0}
    return predict


def test_save_moge_pcd_matches_jax(tmp_path, monkeypatch):
    from street_crafter_tpu.data_processor import moge_pcd as J
    from street_crafter_tpu_torch.data_processor import moge_pcd as P
    from street_crafter_tpu_torch.datasets.synthetic import (IMG_H, IMG_W,
                                                             make_scene)
    src = make_scene(str(tmp_path / "src"), num_frames=2)
    for f in range(2):       # LiDAR depth on the predictor's ramp
        mask = np.zeros((IMG_H, IMG_W), bool)
        mask[IMG_H // 2:] = True
        ramp = 10.0 + 20.0 * (np.arange(IMG_W, dtype=np.float32) / IMG_W)
        np.savez_compressed(
            os.path.join(src, "lidar", "depth", f"{f:06d}_0.npz"), mask=mask,
            value=np.broadcast_to(ramp, (IMG_H, IMG_W))[mask])
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(src, dirs[name])
    assert not P.check_existing(dirs["port"])
    for area in (IMG_H * IMG_W, 40 * 30):
        J.save_moge_pcd(dirs["jax"], _moge_predictor(src),
                        expected_area=area)
        P.save_moge_pcd(dirs["port"], _moge_predictor(src),
                        expected_area=area, device=DEV)
        files = _tree_files(os.path.join(dirs["jax"], "moge"))
        assert files == _tree_files(os.path.join(dirs["port"], "moge"))
        assert os.path.join("actor", "actor_moving", "000000.ply") in files
        for f in files:
            a = read_ply(os.path.join(dirs["port"], "moge", f))
            b = read_ply(os.path.join(dirs["jax"], "moge", f))
            np.testing.assert_allclose(a.points, b.points, rtol=0, atol=1e-5)
            np.testing.assert_array_equal(a.colors, b.colors)
            np.testing.assert_array_equal(a.mask, b.mask)
    assert P.check_existing(dirs["port"]) == J.check_existing(dirs["jax"]) \
        is True
    bk = read_ply(os.path.join(dirs["port"], "moge", "background",
                               "000000.ply"))
    assert len(bk.points) >= 60
    monkeypatch.setitem(sys.modules, "moge", None)
    with pytest.raises(ImportError, match="moge"):
        P.moge_predictor(DEV)

"""The port's Vista clip datasets and ``render_many`` against the JAX
package on the CPU.

The datasets read the same files as ``tests/test_vdm_data.py``'s Vista
test (frames of 40x60 at gray levels 40, 80, 120, one YouTube clip, one
nuScenes sample re-balanced and resampled to four): every array must be
bit-equal to the JAX package's (the port reads PNGs with its own reader
and resizes with its copy of Pillow's fixed-point Lanczos), with the same
sample counts and the same action keys draw by draw (``action_mod``
carries from one draw to the next). ``render_many`` with one and two
workers must write the same files, byte for byte, as
``render_scene_conditions`` called scene by scene.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from street_crafter_tpu.datasets import vdm_data as J
from street_crafter_tpu_torch.data_processor import render_lidar as PR
from street_crafter_tpu_torch.datasets import vdm_data as P
from street_crafter_tpu_torch.utils.png import write_png
from tests.synthetic_scene import make_scene

T = 3
NU_SAMPLE = {"frames": [f"nu_{i}.png" for i in range(T)],
             "cmd": 0, "traj": [0.0] * 10,
             "speed": [1.0] * T, "angle": [78.0] * T,
             "z": 1.0, "goal": [800.0, 450.0]}


@pytest.fixture(scope="module")
def vista_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vista")
    (root / "clip0").mkdir()
    for i in range(T):
        img = np.full((40, 60, 3), 40 * (i + 1), np.uint8)
        # a gradient too, so that the crop and the resize matter
        img[:, :, 1] = np.arange(60, dtype=np.uint8)[None, :] * 3
        write_png(str(root / "clip0" / f"{i:04d}.png"), img)
        write_png(str(root / f"nu_{i}.png"), img)
    (root / "yt.json").write_text(json.dumps(
        [{"folder_name": "clip0", "first_frame": "0000.png"}]))
    (root / "nu.json").write_text(json.dumps(
        [NU_SAMPLE, {**NU_SAMPLE, "cmd": 2, "z": -1.0, "speed": []}]))
    return root


def assert_items_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_youtube_clips_match_jax(vista_root):
    kw = dict(target_height=32, target_width=64, num_frames=T)
    anno = str(vista_root / "yt.json")
    got = P.YouTubeClipDataset(str(vista_root), anno, **kw)
    want = J.YouTubeClipDataset(str(vista_root), anno, **kw)
    assert len(got) == len(want) == 1
    item = got[0]
    assert item["img_seq"].shape == (T, 32, 64, 3)
    assert "guide_seq" not in item
    assert_items_equal(item, want[0])


@pytest.mark.parametrize("balance,resample", [(2, 2), (5, 2), (1, 3)])
def test_nuscenes_clips_match_jax(vista_root, balance, resample):
    kw = dict(target_height=32, target_width=64, num_frames=T,
              balance_factor=balance, resample_factor=resample)
    anno = str(vista_root / "nu.json")
    got = P.NuScenesClipDataset(str(vista_root), anno, **kw)
    want = J.NuScenesClipDataset(str(vista_root), anno, **kw)
    assert len(got) == len(want)
    assert got.samples == want.samples
    # every index, then a few again: action_mod carries across draws
    order = list(range(len(got))) + [3 % len(got), 1, 0, len(got) - 1]
    keys = set()
    for i in order:
        a, b = got[i], want[i]
        assert_items_equal(a, b)
        assert got.action_mod == want.action_mod
        keys |= set(a) - {"img_seq", "cond_frames_without_noise", "fps_id",
                          "motion_bucket_id", "cond_aug"}
    assert keys, "no action conditioning attached"


def test_the_aliases_and_the_resampling_helpers_match_jax(vista_root):
    assert issubclass(P.WaymoClipDataset, P.ClipDataset)
    assert issubclass(P.PandasetClipDataset, P.ClipDataset)
    s = [{"cmd": 2}, {"cmd": 0}, {"cmd": 3}, {"cmd": 1}]
    for f in (1, 3, 5):
        assert P.balance_with_actions(s, f) == J.balance_with_actions(s, f)
        assert P.balance_with_actions(s, f, [0]) == \
            J.balance_with_actions(s, f, [0])
    s2 = [dict(NU_SAMPLE), {**NU_SAMPLE, "z": -1.0},
          {**NU_SAMPLE, "goal": [1700.0, 10.0]}, {**NU_SAMPLE, "angle": []}]
    for f in (1, 2, 4):
        assert P.resample_complete_samples(s2, f) == \
            J.resample_complete_samples(s2, f)
    assert len(P.resample_complete_samples(s2, 2)) == 5
    with pytest.raises(FileNotFoundError):
        P.YouTubeClipDataset(str(vista_root / "missing"),
                             str(vista_root / "yt.json"))
    with pytest.raises(FileNotFoundError):
        P.NuScenesClipDataset(str(vista_root), str(vista_root / "no.json"))


@pytest.fixture(scope="module")
def two_scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    src = make_scene(str(root / "src"), num_frames=2, img_hw=(24, 32))
    for name in ("016", "049"):
        shutil.copytree(src, str(root / "one" / name))
    return root, src


def tree_files(d):
    return sorted(os.path.relpath(os.path.join(a, f), d)
                  for a, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("workers", [1, 2])
def test_render_many_writes_what_one_scene_at_a_time_writes(two_scenes,
                                                            workers):
    root, src = two_scenes
    kw = dict(cams=[0], shifts=[0.0, 2.0], device="cpu")
    ref = root / "one"
    if not (ref / "016" / "lidar" / "color_render").is_dir():
        torch.set_num_threads(1)
        for name in ("016", "049"):
            PR.render_scene_conditions(str(ref / name), **kw)
    out = root / f"many_{workers}"
    for name in ("016", "049"):
        shutil.copytree(src, str(out / name))
    written = PR.render_many(str(out), ["016", "049"], num_workers=workers,
                             **kw)
    assert len(written) == 2 * 2 * 2           # scenes x shifts x frames
    assert [os.path.relpath(p, out) for p in written[:4]] == [
        os.path.join("016", "lidar", t, f"{f:06d}_0.png")
        for t in ("color_render", "color_render_shift_2.00") for f in (0, 1)]
    for name in ("016", "049"):
        want = tree_files(ref / name)
        assert tree_files(out / name) == want
        pngs = [f for f in want if f.startswith(os.path.join(
            "lidar", "color_render"))]
        assert len(pngs) == 2 * 2 * 2          # shifts x frames x rgb/mask
        match, mismatch, errors = filecmp.cmpfiles(
            str(ref / name), str(out / name), want, shallow=False)
        assert not mismatch and not errors, (mismatch, errors)

"""Generic (unknown-pose) COLMAP scene conversion (port of
``street_crafter_tpu/data_processor/colmap_convert.py``).

The vanilla converter for scenes that are not Waymo drives:
feature_extractor -> exhaustive_matcher -> mapper -> image_undistorter over
``<scene>/input``, then ``sparse/*`` moved into ``sparse/0``, and
optionally 2x / 4x / 8x image pyramids (Pillow's Lanczos). Same on-disk
contract (``input/`` in, ``images/`` + ``sparse/0`` out); the COLMAP
runner is injectable, as in ``colmap_driver.py``.

CLI: python -m street_crafter_tpu_torch.data_processor.colmap_convert \
    -s SCENE [--camera OPENCV] [--skip_matching] [--resize] [--use_gpu]
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, Sequence


def _run_colmap(args: Sequence[str]) -> None:
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "the 'colmap' binary is not installed; generic scene conversion "
            "is optional host-side preprocessing")
    subprocess.run(["colmap", *args], check=True)


def convert_colmap_scene(
    source_path: str,
    camera_model: str = "OPENCV",
    skip_matching: bool = False,
    resize: bool = False,
    use_gpu: bool = False,
    runner: Callable[[Sequence[str]], None] = _run_colmap,
) -> str:
    """SfM-convert a generic scene directory.

    Expects ``{source_path}/input/*.jpg|png``. Produces undistorted
    ``{source_path}/images`` + ``{source_path}/sparse/0`` model (and
    ``images_{2,4,8}`` pyramids with resize=True). Returns source_path.
    """
    sp = os.path.abspath(source_path)
    gpu = "1" if use_gpu else "0"
    if not skip_matching:
        os.makedirs(os.path.join(sp, "distorted", "sparse"), exist_ok=True)
        runner([
            "feature_extractor",
            "--database_path", os.path.join(sp, "distorted", "database.db"),
            "--image_path", os.path.join(sp, "input"),
            "--ImageReader.single_camera", "1",
            "--ImageReader.camera_model", camera_model,
            "--SiftExtraction.use_gpu", gpu,
        ])
        runner([
            "exhaustive_matcher",
            "--database_path", os.path.join(sp, "distorted", "database.db"),
            "--SiftMatching.use_gpu", gpu,
        ])
        runner([
            "mapper",
            "--database_path", os.path.join(sp, "distorted", "database.db"),
            "--image_path", os.path.join(sp, "input"),
            "--output_path", os.path.join(sp, "distorted", "sparse"),
            "--Mapper.ba_global_function_tolerance=0.000001",
        ])

    runner([
        "image_undistorter",
        "--image_path", os.path.join(sp, "input"),
        "--input_path", os.path.join(sp, "distorted", "sparse", "0"),
        "--output_path", sp,
        "--output_type", "COLMAP",
    ])

    # move sparse/* -> sparse/0
    sparse = os.path.join(sp, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if resize:
        _build_pyramid(sp)
    return sp


def _build_pyramid(sp: str) -> None:
    """images_{2,4,8} Lanczos pyramids."""
    from PIL import Image

    src = os.path.join(sp, "images")
    for factor in (2, 4, 8):
        dst = os.path.join(sp, f"images_{factor}")
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            with Image.open(os.path.join(src, name)) as im:
                w, h = im.size
                im.resize((max(1, w // factor), max(1, h // factor)),
                          Image.LANCZOS).save(os.path.join(dst, name))


def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser("COLMAP scene converter")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--resize", action="store_true")
    p.add_argument("--use_gpu", action="store_true")
    a = p.parse_args(argv)
    convert_colmap_scene(a.source_path, camera_model=a.camera,
                         skip_matching=a.skip_matching, resize=a.resize,
                         use_gpu=a.use_gpu)


if __name__ == "__main__":
    main()

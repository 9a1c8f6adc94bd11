"""nvcc builds of the port's CUDA sources, one shared library per source.

Every ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
for ``sm_90a`` into ``street_crafter_tpu_torch/build/<name>_<hash>.so`` at
first use (the hash covers the source and the flags, so an edited source
builds anew), then loaded with ctypes. ``build()`` starts one nvcc per
source that is not built yet, all at once, and waits for them: the sources
build in parallel. A failed build raises with nvcc's output. The headers
(``csrc/*.cuh``) are part of every source's hash.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[str]:
    """Names of the CUDA sources (``csrc/<name>.cu``), sorted."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, tuple[Path, str]]:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, started together. Returns {name: (library path,
    ptxas report of its build)}."""
    names = sources() if names is None else list(names)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (lib, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (lib, tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu "
                            f"({proc.returncode}):\n{out}\n{err}")
            continue
        lib.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    result = {}
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        result[name] = (lib, log.read_text() if log.exists() else "")
    return result


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    path, _ = build([name])[name]
    return ctypes.CDLL(str(path))


def require(t, name: str, dtype, shape: tuple | None = None,
            align: int = 16) -> int:
    """Check a kernel argument (CUDA, dtype, shape, contiguous, ``align``-
    byte aligned) and return its device pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
    return t.data_ptr()

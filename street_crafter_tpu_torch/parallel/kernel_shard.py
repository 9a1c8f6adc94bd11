"""The SPMD bridge of the kernels (port of ``street_crafter_tpu/parallel/
kernel_shard.py``) and its x2 kernel.

On a TPU mesh, GSPMD cannot partition a Mosaic call, so the JAX package
wraps each kernel in a ``shard_map`` over the mesh axes the surrounding
computation uses. In PyTorch each rank launches its kernels on its own
tensors, so the bridge reduces to this:

- ``wrap_kernel`` without a context, or in a context with no axes (the
  camera or clip axis is already split between the ranks), is the
  identity, as in JAX;
- in a context with axes (the data axis), the wrapped function runs on
  this rank's shard of the leading dim of every input and the outputs are
  ``all_gather``-ed back along it;
- ``assert_no_context_axes`` guards the kernels whose leading dim is not a
  batch axis (kernels A, B and C of ``ops/gs_raster.py``).

The context is per thread (a stack), entered with ``kernel_sharding``.

``x2`` is the bridge's kernel: out = 2 x, f32 (``csrc/kernel_shard.cu``;
``x2_reference`` is its plain version, the wrapper's path for CPU tensors).
It replaces the x2 Pallas kernel that the JAX package runs per device
through ``wrap_kernel`` under ``vmap(spmd_axis_name="data")``
(``__graft_entry__.py:301-311`` ``_dryrun_kernel_bridge``,
``tests/test_kernel_shard.py:17-27`` ``_scale_kernel`` / ``_impl``): each
rank launches it on its shard, and the gather returns 2 x.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
from typing import Callable, Sequence

import torch

from ..ops import cuda_build
from .mesh import Mesh

_TLS = threading.local()

# kernel launches: "x2" (the CUDA kernel), "x2_reference" (its plain
# version, CPU tensors)
launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launches.clear()


def _stack() -> list:
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


@contextlib.contextmanager
def kernel_sharding(mesh: Mesh | None, axes: Sequence[str] = ()):
    """Kernels wrapped with ``wrap_kernel`` inside this block shard their
    leading dim over ``axes`` of ``mesh`` (axes of size 1 are dropped; an
    empty tuple: the batch is already split between the ranks)."""
    if mesh is None:
        yield
        return
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    _stack().append((mesh, axes))
    try:
        yield
    finally:
        _stack().pop()


def active_kernel_sharding() -> tuple[Mesh, tuple[str, ...]] | None:
    st = _stack()
    return st[-1] if st else None


def assert_no_context_axes(what: str) -> None:
    """Raise when the active context carries axes: ``what``'s leading dim
    is not a batch axis (the raster kernels' is the tile axis), so sharding
    it over the ranks would corrupt the output."""
    ctx = active_kernel_sharding()
    if ctx is not None and ctx[1]:
        raise ValueError(
            f"{what}: active kernel-sharding context carries mesh axes "
            f"{ctx[1]}, but this kernel's leading dim is not a batch axis "
            "— enter kernel_sharding with axes=()")


def wrap_kernel(fn: Callable, in_ranks: Sequence[int],
                out_ranks: Sequence[int] | int) -> Callable:
    """``fn`` under the active context: the identity without one or with no
    axes; else ``fn`` on this rank's shard of every input's leading dim
    (all inputs share it), its outputs gathered along dim 0. ``in_ranks`` /
    ``out_ranks``: the arguments' / outputs' ranks (as JAX's; dim 0 is the
    batch dim, the rest stay whole)."""
    ctx = active_kernel_sharding()
    if ctx is None or not ctx[1]:
        return fn
    mesh = ctx[0]
    # one named axis: its ranks; several: every rank
    axis = ctx[1][0] if len(ctx[1]) == 1 else None
    single = isinstance(out_ranks, int)

    def sharded(*args):
        if len(args) != len(in_ranks):
            raise ValueError(f"{len(args)} arguments, in_ranks "
                             f"{tuple(in_ranks)}")
        for a, r in zip(args, in_ranks):
            if a.dim() != r:
                raise ValueError(f"argument of rank {a.dim()}, expected {r}")
        local = [a[mesh.local_slice(a.shape[0], axis)] for a in args]
        out = fn(*local)
        if single:
            return mesh.all_gather(out, 0, axis)
        return tuple(mesh.all_gather(o, 0, axis) for o in out)

    return sharded


# -- the x2 kernel ----------------------------------------------------------

def x2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: 2 x."""
    return x * 2.0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("kernel_shard")
    P = ctypes.c_void_p
    lib.sc_x2.argtypes = [P, P, ctypes.c_int64, P]
    lib.sc_x2.restype = ctypes.c_int
    lib.sc_error_string.argtypes = [ctypes.c_int]
    lib.sc_error_string.restype = ctypes.c_char_p
    return lib


def x2(x: torch.Tensor) -> torch.Tensor:
    """2 x of a float32 tensor: the kernel on a CUDA tensor (contiguous),
    the plain version on a CPU tensor. A call on the current device does
    only what can change from call to call: the checks, the output, the
    current stream as a raw handle (``torch._C._cuda_getCurrentRawStream``,
    no Stream object) and the launch; a tensor on another device enters it
    first."""
    if x.dtype != torch.float32:
        raise TypeError(f"x2 takes float32, got {x.dtype}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"cpu and cuda tensors only, not {x.device}")
        launches["x2_reference"] += 1
        return x2_reference(x)
    index = x.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return x2(x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    ptr = x.data_ptr()
    if ptr % 4:
        raise ValueError("x must be 4-byte aligned")
    out = torch.empty_like(x)
    err = _library().sc_x2(ptr, out.data_ptr(), x.numel(),
                           torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"x2 launch failed: "
                           f"{_library().sc_error_string(err).decode()} "
                           f"({err})")
    launches["x2"] += 1
    return out

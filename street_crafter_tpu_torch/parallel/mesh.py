"""Process groups for the port's data-parallel paths (port of
``street_crafter_tpu/parallel/mesh.py``).

The JAX package lays named axes (``data``, ``frames``) over a device mesh
and lets XLA insert the collectives. The port runs one process per rank
under ``torch.distributed`` (the reference's Lightning DDP / DeepSpeed
ZeRO-2 over NCCL, ``waymo_high_res_mix.yaml:250``): ``make_mesh`` joins or
starts the process group and returns a ``Mesh`` that carries the axis
sizes, this rank and its device, and the three collectives the port uses
(``all_reduce_``, ``all_gather``, ``broadcast_``). With world size 1, or no
process group at all, every collective is the identity, so the one-device
paths run exactly as they do without a mesh.

Backends: NCCL on ``cuda``, gloo on ``cpu``, and gloo on ``cuda`` only
where the caller asks for it (two ranks that share one card: NCCL refuses
two ranks on one device). gloo moves CUDA tensors through host memory:
``Mesh`` copies each to the host, runs the collective there and copies the
result back (gloo's own CUDA support does not cover ``all_gather``).

Only the ``data`` axis may be larger than 1. The JAX design's sequence
parallelism over ``frames`` has no counterpart in the port yet (ROADMAP
queue 1, item 31).

``run_ranks`` is the test helper that replaces ``make_virtual_cpu_mesh``:
it spawns N processes joined by a ``file://`` rendezvous and runs a
function on each.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue
import time
import traceback
import uuid
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist

FRAMES_AXIS_NOT_PORTED = (
    "the frames axis (the JAX design's sequence parallelism of the "
    "fine-tune step and parallel/sample.py) has no counterpart in the port "
    "(ROADMAP queue 1, item 31); only the data axis may be > 1")
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes. A size of -1 absorbs all remaining devices."""

    axes: Mapping[str, int]

    def resolve(self, n_devices: int) -> dict[str, int]:
        axes = dict(self.axes)
        fixed = 1
        wildcard = None
        for name, size in axes.items():
            if size == -1:
                if wildcard is not None:
                    raise ValueError("at most one mesh axis may be -1")
                wildcard = name
            else:
                fixed *= size
        if wildcard is not None:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            axes[wildcard] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    f"mesh axes product {fixed} != device count {n_devices}")
        return axes


@dataclasses.dataclass
class Mesh:
    """A data-parallel group: the axis sizes, this rank, its device, and
    the process group's backend (None: no group, collectives are the
    identity)."""

    shape: dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str | None = None

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def _staged(self) -> bool:
        """gloo on a card: collectives run on host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _active(self) -> bool:
        return self.backend is not None and self.world_size > 1

    def all_reduce_(self, tensors: Sequence[torch.Tensor],
                    op: str = "sum") -> None:
        """In place, over every rank: the sum (or ``op="max"``)."""
        if not self._active():
            return
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        for t in tensors:
            if self._staged:
                host = t.cpu()
                dist.all_reduce(host, rop)
                t.copy_(host)
            else:
                dist.all_reduce(t, rop)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in
        rank order."""
        if not self._active():
            return x
        src = x.cpu() if self._staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim)
        return out.to(x.device) if self._staged else out

    def broadcast_(self, tensors: Sequence[torch.Tensor],
                   src: int = 0) -> None:
        """In place: rank ``src``'s values on every rank."""
        if not self._active():
            return
        for t in tensors:
            if self._staged:
                host = t.cpu()
                dist.broadcast(host, src)
                t.copy_(host)
            else:
                dist.broadcast(t, src)

    def barrier(self) -> None:
        if self._active():
            dist.barrier()

    def local_slice(self, n: int) -> slice:
        """This rank's part of a leading dim of ``n`` (``data`` ranks each
        take n / data consecutive entries)."""
        w = self.world_size
        if n % w:
            raise ValueError(f"{n} does not split over {w} ranks")
        m = n // w
        return slice(self.rank * m, (self.rank + 1) * m)


def make_mesh(spec: MeshSpec | Mapping[str, int] | None = None,
              device: torch.device | str | None = None,
              backend: str | None = None, rank: int | None = None,
              world_size: int | None = None, init_method: str | None = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join the process group (or start it) and resolve ``spec`` (default
    ``{"data": -1}``) over its world size.

    Rank and world size come from an initialised process group, else from
    the arguments, else from torchrun's environment (``RANK``,
    ``WORLD_SIZE``; world size 1 without it: no group is started). A
    ``cuda`` device without an index is ``cuda:LOCAL_RANK`` and becomes the
    current device. The backend is NCCL on ``cuda`` and gloo on ``cpu``
    unless ``backend`` says otherwise (gloo, for ranks sharing a card)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    joined = dist.is_available() and dist.is_initialized()
    if joined:
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend())
    else:
        world = int(world_size if world_size is not None
                    else os.environ.get("WORLD_SIZE", 1))
        rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if spec is None:
        spec = {"data": -1}
    if not isinstance(spec, MeshSpec):
        spec = MeshSpec(dict(spec))
    if any(int(n) > 1 for name, n in spec.axes.items() if name != "data"):
        raise NotImplementedError(f"mesh {dict(spec.axes)}: "
                                  f"{FRAMES_AXIS_NOT_PORTED}")
    axes = spec.resolve(world)
    if any(n > 1 for name, n in axes.items() if name != "data"):
        raise NotImplementedError(f"mesh {axes}: {FRAMES_AXIS_NOT_PORTED}")
    if not joined:
        if world > 1:
            backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
            dist.init_process_group(
                backend, init_method=init_method or "env://", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=timeout_s))
        else:
            backend = None
    return Mesh(shape=axes, rank=rank, device=dev, backend=backend)


def axis_size(mesh: Mesh | None, name: str) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(name, 1)


def _rank_main(fn: Callable, rank: int, world: int, init_file: str,
               backend: str, device: str, threads: int, timeout_s: float,
               args: tuple, results: Any) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = make_mesh(device=device, backend=backend, rank=rank,
                         world_size=world, init_method=f"file://{init_file}",
                         timeout_s=timeout_s)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:               # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, rendezvous_dir: str,
              *args: Any, backend: str = "gloo", device: str = "cpu",
              threads: int = 1, timeout_s: float = TIMEOUT_S) -> list:
    """``fn(mesh, *args)`` in ``world_size`` spawned processes joined by a
    ``file://`` rendezvous under ``rendezvous_dir``; returns the ranks'
    results (picklable) in rank order. Each child sets ``threads`` torch
    threads (0: torch's default). A rank that raises fails the call with
    its traceback; one that dies, or a group that does not finish within
    ``timeout_s``, fails it too. Every child is stopped on return."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(os.path.abspath(rendezvous_dir),
                             f"rendezvous_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, init_file, backend, device, threads, timeout_s,
        args, results)) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out: dict[int, Any] = {}
    try:
        while len(out) < world_size:
            if time.monotonic() > deadline:
                missing = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(f"ranks {missing} did not finish within "
                                   f"{timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that returns or raises has put its message before
                # exiting with 0: only a crash leaves another exit code
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited (codes "
                                       f"{[procs[r].exitcode for r in dead]}) "
                                       f"without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    return [out[r] for r in range(world_size)]

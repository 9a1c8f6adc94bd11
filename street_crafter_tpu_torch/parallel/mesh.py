"""Process groups of the port's parallel paths (port of
``street_crafter_tpu/parallel/mesh.py``).

The JAX package lays named axes (``data``, ``frames``) over a device mesh
and lets XLA insert the collectives. The port runs one process per rank
under ``torch.distributed`` (the reference's Lightning DDP / DeepSpeed
ZeRO-2 over NCCL, ``waymo_high_res_mix.yaml:250``): ``make_mesh`` joins or
starts the process group and returns a ``Mesh`` that carries the axis
sizes, this rank and its device, one process group per axis, and the
collectives the port uses (``all_reduce_``, ``all_gather``,
``broadcast_``, ``all_to_all`` and ``halo``), each over one axis
(``axis="data"`` or ``"frames"``) or over every rank (``axis=None``).
With world size 1, or no process group at all, every collective is the
identity, so the one-device paths run exactly as they do without a mesh.

Axes are laid out in the spec's order, the last one innermost, as JAX's
``make_mesh`` lays its devices: ``{"data": 2, "frames": 4}`` puts rank
``data_index * 4 + frames_index``. ``frames`` carries the JAX design's
sequence parallelism (``parallel/sequence.py``): a clip's frames split
over the axis, and the temporal stages exchange them.

Backends: NCCL on ``cuda``, gloo on ``cpu``, and gloo on ``cuda`` only
where the caller asks for it (ranks that share one card: NCCL refuses two
ranks on one device). gloo moves CUDA tensors through host memory:
``Mesh`` copies each to the host, runs the collective there and copies the
result back (gloo's own CUDA support does not cover ``all_gather``).

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
from typing import Any, Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

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
    """Named axes over the ranks: the axis sizes (in layout order, the last
    innermost), this rank, its device, the process group's backend (None:
    no group, collectives are the identity) and, by axis, the group of the
    ranks that share every other coordinate with this one (None: the axis
    spans every rank, and the world group serves)."""

    shape: dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    groups: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str | None = None) -> int:
        """The number of ranks along ``axis`` (every rank: None)."""
        return self.world_size if axis is None else self.shape.get(axis, 1)

    def _stride(self, axis: str) -> int:
        names = list(self.shape)
        return math.prod(self.shape[n] for n in names[names.index(axis) + 1:])

    def coord(self, axis: str | None) -> int:
        """This rank's index along ``axis`` (its rank: None)."""
        if axis is None:
            return self.rank
        if axis not in self.shape:
            return 0
        return (self.rank // self._stride(axis)) % self.shape[axis]

    def axis_ranks(self, axis: str | None) -> list[int]:
        """The global ranks along ``axis`` through this rank, in axis
        order."""
        if axis is None:
            return list(range(self.world_size))
        if axis not in self.shape:
            return [self.rank]
        st = self._stride(axis)
        base = self.rank - self.coord(axis) * st
        return [base + i * st for i in range(self.shape[axis])]

    @property
    def _staged(self) -> bool:
        """gloo on a card: collectives run on host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _active(self, axis: str | None = None) -> bool:
        return self.backend is not None and self.size(axis) > 1

    def _group(self, axis: str | None) -> Optional[Any]:
        return None if axis is None else self.groups.get(axis)

    def all_reduce_(self, tensors: Sequence[torch.Tensor],
                    op: str = "sum", axis: str | None = None) -> None:
        """In place, over the ranks along ``axis``: the sum (or
        ``op="max"``)."""
        if not self._active(axis):
            return
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        group = self._group(axis)
        for t in tensors:
            if self._staged:
                host = t.cpu()
                dist.all_reduce(host, rop, group=group)
                t.copy_(host)
            else:
                dist.all_reduce(t, rop, group=group)

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   axis: str | None = None) -> torch.Tensor:
        """Every ``axis`` rank's ``x`` (equal shapes), concatenated along
        ``dim`` in axis order."""
        if not self._active(axis):
            return x
        src = x.cpu() if self._staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(parts, src, group=self._group(axis))
        out = torch.cat(parts, dim)
        return out.to(x.device) if self._staged else out

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0,
                   axis: str | None = None) -> None:
        """In place: the values of the rank at index ``src`` along ``axis``
        on every rank along it."""
        if not self._active(axis):
            return
        root = self.axis_ranks(axis)[src]
        group = self._group(axis)
        for t in tensors:
            if self._staged:
                host = t.cpu()
                dist.broadcast(host, root, group=group)
                t.copy_(host)
            else:
                dist.broadcast(t, root, group=group)

    def all_to_all(self, inputs: Sequence[torch.Tensor],
                   out_shapes: Sequence[Sequence[int]],
                   axis: str | None = None) -> list[torch.Tensor]:
        """``inputs[j]`` to the rank at index j along ``axis``; returns what
        each rank there sent to this one, of ``out_shapes[j]``, in axis
        order. Sizes may differ and be 0; every tensor has one dtype."""
        n = self.size(axis)
        if len(inputs) != n or len(out_shapes) != n:
            raise ValueError(f"{len(inputs)} inputs and {len(out_shapes)} "
                             f"shapes for {n} ranks")
        if not self._active(axis):
            return [inputs[0].reshape(tuple(out_shapes[0]))]
        dtype = inputs[0].dtype
        dev = torch.device("cpu") if self._staged else inputs[0].device
        flat = torch.cat([t.reshape(-1) for t in inputs]).to(dev)
        in_splits = [t.numel() for t in inputs]
        out_splits = [math.prod(s) for s in out_shapes]
        out = torch.empty(sum(out_splits), dtype=dtype, device=dev)
        dist.all_to_all_single(out, flat, out_splits, in_splits,
                               group=self._group(axis))
        out = out.to(inputs[0].device)
        return [p.reshape(tuple(s)) for p, s in
                zip(out.split(out_splits), out_shapes)]

    def halo(self, x: torch.Tensor, k: int, dim: int = 0,
             axis: str = "frames") -> torch.Tensor:
        """``x`` with ``k`` entries of ``dim`` from each neighbour along
        ``axis`` on either side (the previous rank's last k before, the next
        rank's first k after), and zeros past the ends of the axis."""
        n, i = self.size(axis), self.coord(axis)
        L = x.shape[dim]
        if k > L:
            raise ValueError(f"a halo of {k} from {L} entries")
        edge = list(x.shape)
        edge[dim] = k
        empty = [0] * len(edge)
        sends = [x.new_zeros(empty) for _ in range(n)]
        shapes = [empty] * n
        if i > 0:
            sends[i - 1] = x.narrow(dim, 0, k)
            shapes[i - 1] = edge
        if i < n - 1:
            sends[i + 1] = x.narrow(dim, L - k, k)
            shapes[i + 1] = edge
        got = (self.all_to_all(sends, shapes, axis) if n > 1
               else [x.new_zeros(empty)])
        before = got[i - 1] if i > 0 else x.new_zeros(edge)
        after = got[i + 1] if i < n - 1 else x.new_zeros(edge)
        return torch.cat([before, x, after], dim)

    def barrier(self) -> None:
        if self._active():
            dist.barrier()

    def local_slice(self, n: int, axis: str | None = "data") -> slice:
        """This rank's part of a leading dim of ``n``: ranks along ``axis``
        (every rank: None) each take n / size consecutive entries, in axis
        order."""
        w = self.size(axis)
        if n % w:
            raise ValueError(f"{n} does not split over {w} ranks")
        m = n // w
        i = self.coord(axis)
        return slice(i * m, (i + 1) * m)


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
    axes = spec.resolve(world)
    if not joined:
        if world > 1:
            backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
            dist.init_process_group(
                backend, init_method=init_method or "env://", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=timeout_s))
        else:
            backend = None
    mesh = Mesh(shape=axes, rank=rank, device=dev, backend=backend)
    if backend is not None:
        mesh.groups = _axis_groups(mesh)
    return mesh


def _axis_groups(mesh: Mesh) -> dict[str, Any]:
    """One process group per axis of size 1 < n < world: every rank
    creates every group, in the same order (``new_group`` is collective),
    and keeps the ones it belongs to."""
    groups: dict[str, Any] = {}
    world = mesh.world_size
    for axis, n in mesh.shape.items():
        if n <= 1 or n >= world:
            continue
        st = mesh._stride(axis)
        bases = sorted({r - ((r // st) % n) * st for r in range(world)})
        for base in bases:
            ranks = [base + i * st for i in range(n)]
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                groups[axis] = g
    return groups


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

"""K1's in-kernel row compaction, as a variant bench of kernel A.

Port of the TPU kernels of ``scripts/bench_phase1_variants.py`` (``kernel``
and ``rowbatch_kernel``): one coarse tile's depth-sorted candidates
[T, kc, 11] f32 (depth in column 8, the y span [y0, y1) in columns 9 and
10) are compacted into 8 lists, one per 16-px row of the 128-px coarse tile
([T, 8, kf, 11], with counts [T, 8]). A candidate is kept in a row when its
span meets the row and its depth is below 1e10; the lists keep depth
order, at most kf slots a row. The walk goes over blocks of ``kb``
candidates and stops before a block once the count reached kf (``base``:
per row; ``rowbatch``: once every row's has) or after a block that held a
dead candidate; a count is not capped inside the last block it walked,
the slots are. Variants:

  * ``base``: each row's walk on its own, kb = 128 (the TPU's ``kernel``,
    a program per (coarse tile, row));
  * ``rowbatch``: one walk for all 8 rows of a coarse tile (kb 128 or 256;
    the TPU's ``rowbatch_kernel``); rows that are full go on counting while
    another row is open;
  * ``bf16``: ``base`` with the compacted values rounded to bf16 (as the
    TPU kernel's bf16 one-hot product rounds them);
  * ``count_only``: the mask and the counts without the scatter (the TPU
    bench's no-upd / no-ind ablations).

``compact_rows_reference`` is the plain torch version (CPU tensors, and
the oracle on the card); ``compact_rows`` launches the kernel of
``csrc/row_compact.cu`` on CUDA tensors: one template for the four
variants, over (chunk of ``CHUNK`` candidates, coarse tile), each chunk
read once for all 8 rows by a bulk copy and the walk resolved across
chunks by a chained scan (decoupled look-back). Slots past a row's count
are not written by the kernel (zeros in the plain version). ``checksums``
reduces a result as the TPU bench's programs do. Nothing on the port's
main paths calls these: they are kernel A's variant bench (``scripts/
bench_phase1_variants.py`` of this package).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import cuda_build

ROWS = 8                 # 16-px rows of a coarse tile
COARSE = 128             # coarse tile side, px
ROW = 16                 # fine row height, px
TILES_X = 13             # coarse tiles per row of the headline grid
KF = 1024                # slots per row
A = 11                   # floats per candidate
DEPTH, Y0, Y1 = 8, 9, 10
DEAD = 1e10              # a candidate at or past this depth is dead
VARIANTS = ("base", "rowbatch", "bf16", "count_only")
ROWBATCH_KB = (128, 256)
CHUNK = 512              # candidates a CTA of the kernel (csrc's kChunk)

# kernel launches per variant ("base", "rowbatch", "bf16", "count_only";
# "rowbatch_kb256" for the rowbatch kernel over blocks of 256)
launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launches.clear()


def _check_args(cand: torch.Tensor, variant: str, kb: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant}")
    if cand.dim() != 3 or cand.shape[2] != A:
        raise ValueError(f"candidates must be [T, kc, {A}], got "
                         f"{tuple(cand.shape)}")
    if cand.dtype != torch.float32:
        raise TypeError(f"candidates must be float32, got {cand.dtype}")
    allowed = ROWBATCH_KB if variant == "rowbatch" else (128,)
    if kb not in allowed:
        raise ValueError(f"{variant}: kb must be one of {allowed}, got {kb}")
    if cand.shape[1] % kb:
        raise ValueError(f"kc = {cand.shape[1]} is not a multiple of {kb}")


def _walk(cand: torch.Tensor, variant: str, kb: int):
    """(row masks [T, 8, kc], per-block kept counts [T, 8, nb], walked
    blocks [T, 8, nb] bool): the blocks a walk visits are a prefix, those
    before which every earlier block was all alive and a row was open
    (base, bf16, count_only: this row; rowbatch: any row of the tile)."""
    T, kc, _ = cand.shape
    dev = cand.device
    ry0 = ((torch.arange(T, device=dev) // TILES_X * COARSE)[:, None]
           + torch.arange(ROWS, device=dev)[None, :] * ROW).float()
    alive = cand[..., DEPTH] < DEAD                              # [T, kc]
    mask = ((cand[:, None, :, Y0] < (ry0 + ROW)[..., None])
            & (cand[:, None, :, Y1] > ry0[..., None])
            & alive[:, None, :])                                 # [T, 8, kc]
    nb = kc // kb
    per_block = mask.view(T, ROWS, nb, kb).sum(-1)               # [T, 8, nb]
    open_ = (torch.cumsum(per_block, -1) - per_block) < KF
    if variant == "rowbatch":
        open_ = open_.any(1, keepdim=True).expand_as(open_)
    dead = (~alive.view(T, nb, kb).all(-1)).long()               # [T, nb]
    tail = (torch.cumsum(dead, -1) - dead) == 0
    walked = torch.cumprod((open_ & tail[:, None, :]).long(), -1).bool()
    return mask, per_block, walked


def walked_blocks(cand: torch.Tensor, variant: str = "base",
                  kb: int = 128) -> torch.Tensor:
    """[T, 8] blocks of ``kb`` candidates each row's walk reads."""
    _check_args(cand, variant, kb)
    return _walk(cand, variant, kb)[2].sum(-1)


def compact_rows_reference(cand: torch.Tensor, variant: str = "base",
                           kb: int = 128
                           ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(lists [T, 8, kf, 11] f32, zeros past each count; None for
    ``count_only``), counts [T, 8] int32. Plain torch, vectorised: the
    walked blocks are a prefix, so a candidate's slot is its exclusive
    prefix count of kept candidates."""
    _check_args(cand, variant, kb)
    mask, per_block, walked = _walk(cand, variant, kb)
    counts = (per_block * walked).sum(-1).to(torch.int32)
    if variant == "count_only":
        return None, counts
    kept = mask & walked.repeat_interleave(kb, -1)
    slot = torch.cumsum(kept.long(), -1) - 1
    kept &= slot < KF
    values = cand
    if variant == "bf16":
        values = cand.to(torch.bfloat16).float()
    T = cand.shape[0]
    comp = torch.zeros((T, ROWS, KF, A), dtype=torch.float32,
                       device=cand.device)
    t_idx, r_idx, j_idx = torch.nonzero(kept, as_tuple=True)
    comp[t_idx, r_idx, slot[t_idx, r_idx, j_idx]] = values[t_idx, j_idx]
    return comp, counts


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("row_compact")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sc_compact_rows.argtypes = [P, I, I, I, I, I, P, P, P, P]
    lib.sc_compact_rows.restype = I
    lib.sc_error_string.argtypes = [I]
    lib.sc_error_string.restype = ctypes.c_char_p
    return lib


_VARIANT_CODE = {"base": 0, "bf16": 1, "count_only": 2, "rowbatch": 3}
_LAUNCH_NAME = {(v, 128): v for v in VARIANTS}
_LAUNCH_NAME[("rowbatch", 256)] = "rowbatch_kb256"


def _compact_rows_cuda(cand, variant, kb):
    """The launch. On the current device it does only what can change from
    call to call: the checks, one float32 and one int32 allocation (the
    counts are the int32 one's first T * 8 words, the kernel's workspace
    the rest), the raw current stream (no Stream object) and the launch; a
    tensor on another device enters it first."""
    index = cand.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return _compact_rows_cuda(cand, variant, kb)
    if not cand.is_contiguous():
        raise ValueError("candidates must be contiguous")
    ptr = cand.data_ptr()
    if ptr % 16:
        raise ValueError("candidates must be 16-byte aligned")
    lib = _library()
    T, kc, _ = cand.shape
    comp = (None if variant == "count_only" else
            torch.empty((T, ROWS, KF, A), dtype=torch.float32,
                        device=cand.device))
    # the workspace (csrc's sc_compact_rows_workspace): a ticket a tile, a
    # status word a (tile, chunk, row)
    words = T * (1 + ROWS * -(-kc // CHUNK))
    buf = torch.empty(T * ROWS + words, dtype=torch.int32,
                      device=cand.device)
    counts = buf.as_strided((T, ROWS), (ROWS, 1))
    work = buf.data_ptr() + 4 * T * ROWS
    err = lib.sc_compact_rows(
        ptr, T, kc, KF, _VARIANT_CODE[variant], kb,
        None if comp is None else comp.data_ptr(), buf.data_ptr(), work,
        torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"compact_rows launch failed: "
                           f"{lib.sc_error_string(err).decode()} ({err})")
    if kc:  # no candidates: a memset of the counts, no kernel
        launches[_LAUNCH_NAME[variant, kb]] += 1
    return comp, counts


def compact_rows(cand: torch.Tensor, variant: str = "base", kb: int = 128
                 ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """As ``compact_rows_reference``; on CUDA tensors the kernel, whose
    slots past each count are left unwritten."""
    _check_args(cand, variant, kb)
    if cand.is_cuda:
        return _compact_rows_cuda(cand, variant, kb)
    if cand.device.type != "cpu":
        raise ValueError(f"cpu and cuda tensors only, not {cand.device}")
    return compact_rows_reference(cand, variant, kb)


def checksums(comp: torch.Tensor | None, counts: torch.Tensor,
              variant: str) -> torch.Tensor:
    """The TPU bench's per-program result: for ``rowbatch`` per coarse tile
    [T] the sum of the 8 counts plus the sum of row 0's first compacted
    candidate's 11 values; otherwise per (tile, row) [T, 8] the count plus
    the sum of that row's first candidate (``count_only``: the count)."""
    first = None
    if comp is not None:
        first = torch.where(counts[..., None] > 0, comp[:, :, 0, :],
                            0.0).sum(-1)                          # [T, 8]
    if variant == "rowbatch":
        return counts.float().sum(1) + first[:, 0]
    if first is None:
        return counts.float()
    return counts.float() + first

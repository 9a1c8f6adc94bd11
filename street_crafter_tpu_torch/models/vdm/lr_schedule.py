"""Fine-tune learning-rate multiplier schedules (port of
``street_crafter_tpu/models/vdm/lr_schedule.py``; vwm/lr_scheduler.py).

A schedule maps the optimizer step to a multiplier of the base lr. The
StreetCrafter fine-tune wires ``LambdaLinearScheduler`` in
(waymo_high_res_mix.yaml:163-170); its config degenerates to a constant
multiplier (warm-up 0, f_min = f_max = 1), but the cycles are part of the
recipe. Arithmetic in f32, as the JAX package's.
"""

from __future__ import annotations

import bisect
from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]


def _cycles(warm_up_steps, f_start, f_max, f_min, cycle_lengths):
    n = len(cycle_lengths)
    if not len(warm_up_steps) == len(f_start) == len(f_max) == len(f_min) \
            == n:
        raise ValueError("schedule lists differ in length")
    f32 = np.float32
    cum = np.concatenate([[0.0], np.cumsum(np.asarray(cycle_lengths,
                                                      np.float64))])
    return ([f32(x) for x in warm_up_steps], [f32(x) for x in f_start],
            [f32(x) for x in f_max], [f32(x) for x in f_min],
            [f32(x) for x in cycle_lengths], [f32(x) for x in cum])


def _locate(step, cum):
    """(cycle, steps into it): the JAX package's searchsorted over the
    cumulative cycle ends, side left, clipped to the last cycle."""
    s = np.float32(step)
    cyc = min(bisect.bisect_left(cum[1:], s), len(cum) - 2)
    return cyc, np.float32(s - cum[cyc])


def _warmup(n, wu, fs, fx):
    return (fx - fs) / max(wu, np.float32(1.0)) * n + fs


def lambda_linear_schedule(
    warm_up_steps: Sequence[float] = (0,),
    f_start: Sequence[float] = (1e-6,),
    f_max: Sequence[float] = (1.0,),
    f_min: Sequence[float] = (1.0,),
    cycle_lengths: Sequence[float] = (10_000_000_000_000,),
) -> Schedule:
    """LambdaLinearScheduler (lr_scheduler.py:82-96): linear warm-up, then
    linear decay f_max -> f_min across the cycle."""
    wu, fs, fx, fm, cl, cum = _cycles(warm_up_steps, f_start, f_max, f_min,
                                      cycle_lengths)

    def schedule(step: int) -> float:
        c, n = _locate(step, cum)
        if n < wu[c]:
            return float(np.float32(_warmup(n, wu[c], fs[c], fx[c])))
        return float(np.float32(fm[c] + (fx[c] - fm[c]) * (cl[c] - n)
                                / cl[c]))

    return schedule


def lambda_warmup_cosine_schedule(
    warm_up_steps: Sequence[float],
    f_start: Sequence[float],
    f_max: Sequence[float],
    f_min: Sequence[float],
    cycle_lengths: Sequence[float],
) -> Schedule:
    """LambdaWarmUpCosineScheduler2 (lr_scheduler.py:36-79): linear
    warm-up, then half-cosine decay f_max -> f_min across each cycle."""
    wu, fs, fx, fm, cl, cum = _cycles(warm_up_steps, f_start, f_max, f_min,
                                      cycle_lengths)

    def schedule(step: int) -> float:
        c, n = _locate(step, cum)
        if n < wu[c]:
            return float(np.float32(_warmup(n, wu[c], fs[c], fx[c])))
        t = min((n - wu[c]) / max(cl[c] - wu[c], np.float32(1.0)),
                np.float32(1.0))
        return float(np.float32(fm[c] + np.float32(0.5) * (fx[c] - fm[c])
                                * (1 + np.cos(np.float32(t * np.pi)))))

    return schedule


def schedule_from_config(node) -> Schedule | None:
    """The ``vdm_train.scheduler`` node ({"type": "lambda_linear" |
    "warmup_cosine" | "", ...}) -> a schedule; None (constant 1) when the
    type is empty, as a reference run without scheduler_config."""
    if node is None:
        return None
    kind = str(node.get("type", "") or "")
    if not kind:
        return None
    kw = {k: list(node[k]) for k in ("warm_up_steps", "f_start", "f_max",
                                     "f_min", "cycle_lengths") if k in node}
    if kind == "lambda_linear":
        return lambda_linear_schedule(**kw)
    if kind == "warmup_cosine":
        return lambda_warmup_cosine_schedule(**kw)
    raise ValueError(f"unknown scheduler type {kind!r}")

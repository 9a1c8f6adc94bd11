"""Scene leaves and train state <-> nested dicts of arrays.

``scene_from_numpy`` takes the JAX package's ``SceneParams`` / ``SceneMeta``
leaves as a nested dict of numpy arrays (same field names, pools as dicts of
their fields, absent parts as None) and builds the port's scene; this is how
the same weights reach both packages. ``params_to_dict`` is its inverse for
the port's own checkpoints, whose pools keep the saved sizes.
``train_state_from_dict`` / ``train_state_to_numpy`` do the same for the
whole train state (parameters, per-pool and misc Adam moments and counts,
densify statistics, step), so a JAX train state carries across and the
tests compare both ways. The cubemap sky (``sky_cubemap``) and the colour
MLPs (``color_mlp``, ``color_mlp_sky``: dicts of their weights) are leaves
like any other; their moments sit in the misc Adam state under the
trainer's names (``sky_cubemap``, ``color_mlp.w0``, ...). Leaves a state
lacks stay None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .params import FIELDS, GaussianPool
from .scene import SceneMeta, SceneParams

_POOLS = ("bkgd", "actors", "sky")


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    return torch.tensor(a, dtype=torch.bool if a.dtype == bool
                        else torch.float32, device=device)


def _map(x, f):
    if x is None:
        return None
    if isinstance(x, Mapping):
        return {k: _map(v, f) for k, v in x.items()}
    return f(x)


def params_from_dict(d: Mapping[str, Any],
                     device: torch.device | str = "cpu") -> SceneParams:
    kw = {}
    for f in dataclasses.fields(SceneParams):
        x = d.get(f.name)
        if x is None:
            kw[f.name] = None
        elif f.name in _POOLS:
            kw[f.name] = GaussianPool(**{k: _tensor(x[k], device)
                                         for k in FIELDS})
        elif isinstance(x, Mapping):       # colour MLP weights
            kw[f.name] = {k: _tensor(v, device) for k, v in x.items()}
        else:
            kw[f.name] = _tensor(x, device)
    return SceneParams(**kw)


def meta_from_dict(d: Mapping[str, Any],
                   device: torch.device | str = "cpu") -> SceneMeta:
    kw = {}
    for f in dataclasses.fields(SceneMeta):
        x = d.get(f.name)
        if f.name == "fourier_scale":
            kw[f.name] = float(1.0 if x is None else x)
        else:
            kw[f.name] = None if x is None else _tensor(x, device)
    return SceneMeta(**kw)


def scene_from_numpy(params: Mapping[str, Any],
                     meta: Mapping[str, Any] | None = None,
                     device: torch.device | str = "cpu"
                     ) -> tuple[SceneParams, SceneMeta | None]:
    """Nested dicts of numpy arrays (JAX leaves) -> the port's scene."""
    return (params_from_dict(params, device),
            None if meta is None else meta_from_dict(meta, device))


def params_to_dict(params: SceneParams) -> dict[str, Any]:
    """SceneParams -> nested dict of detached tensors (None for absent
    parts)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(SceneParams):
        x = getattr(params, f.name)
        if isinstance(x, GaussianPool):
            x = {k: getattr(x, k) for k in FIELDS}
        out[f.name] = _map(x, torch.Tensor.detach)
    return out


# -- train state: the JAX GSTrainState's leaves <-> the port's ---------------

_ADAMS = ("adam_bkgd", "adam_actors", "adam_sky", "adam_misc")
_DSTATES = ("dstate_bkgd", "dstate_actors", "dstate_sky")


def train_state_to_dict(state, f=torch.Tensor.detach) -> dict[str, Any]:
    """GSTrainState -> nested dict (the JAX GSTrainState's field names;
    Adam states as {m, v, count}, densify states as dicts of their fields),
    each tensor mapped by ``f``."""
    out = {"params": _map(params_to_dict(state.params), f),
           "step": int(state.step)}
    for name in _ADAMS:
        a = getattr(state, name)
        out[name] = None if a is None else {
            "m": _map(a.m, f), "v": _map(a.v, f), "count": f(a.count)}
    for name in _DSTATES:
        d = getattr(state, name)
        out[name] = None if d is None else {
            k.name: f(getattr(d, k.name)) for k in dataclasses.fields(d)}
    return out


def train_state_to_numpy(state) -> dict[str, Any]:
    return train_state_to_dict(state, lambda t: t.cpu().numpy())


def train_state_from_dict(d: Mapping[str, Any],
                          device: torch.device | str = "cpu",
                          params: SceneParams | None = None):
    """Nested dict (from ``train_state_to_dict``, or the JAX GSTrainState's
    leaves as numpy) -> the port's GSTrainState; ``params`` replaces
    d["params"] when given."""
    from ...training.gs_trainer import GSTrainState, set_trainable
    from .densify import DensifyState
    from .optim import GaussianAdamState

    def count(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.int32)
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    if params is None:
        params = params_from_dict(d["params"], device)
    set_trainable(params)
    kw: dict[str, Any] = {"params": params, "step": int(np.asarray(d["step"]))}
    for name in _ADAMS:
        a = d.get(name)
        kw[name] = None if a is None else GaussianAdamState(
            m={k: _tensor(v, device) for k, v in a["m"].items()},
            v={k: _tensor(v, device) for k, v in a["v"].items()},
            count=count(a["count"]))
    for name in _DSTATES:
        x = d.get(name)
        kw[name] = None if x is None else DensifyState(
            **{k: _tensor(v, device) for k, v in x.items()})
    return GSTrainState(**kw)

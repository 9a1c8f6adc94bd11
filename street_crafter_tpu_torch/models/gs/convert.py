"""Scene leaves <-> nested dicts of arrays.

``scene_from_numpy`` takes the JAX package's ``SceneParams`` / ``SceneMeta``
leaves as a nested dict of numpy arrays (same field names, pools as dicts of
their fields, absent parts as None) and builds the port's scene; this is how
the same weights reach both packages. ``params_to_dict`` is its inverse for
the port's own checkpoints, whose pools keep the saved sizes.
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
    """SceneParams -> nested dict of tensors (None for absent parts)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(SceneParams):
        x = getattr(params, f.name)
        if isinstance(x, GaussianPool):
            x = {k: getattr(x, k) for k in FIELDS}
        out[f.name] = x
    return out

"""LPIPS perceptual distance, VGG16 variant (port of
``street_crafter_tpu/ops/lpips.py``).

Same topology, feature taps (relu1_2 .. relu5_3), input shift/scale and
per-channel linear heads as the JAX package, and the same parameter dict
and npz format: ``conv{i}_w`` [3, 3, Cin, Cout] (HWIO), ``conv{i}_b``
[Cout], ``lin{i}_w`` [C]. The convolutions run as ``F.conv2d`` in NCHW; the
public functions take the JAX package's [N, H, W, 3] / [H, W, 3] layout in
[0, 1]. No weights ship with the repository: ``load_lpips`` returns None
when no npz is given, and ``random_feature_lpips`` is the seeded stand-in
the trainer takes under ``optim.lpips_fallback=random_features``.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, pool_before)
_VGG16 = [(64, False), (64, False),
          (128, True), (128, False),
          (256, True), (256, False), (256, False),
          (512, True), (512, False), (512, False),
          (512, True), (512, False), (512, False)]
# feature taps after these conv indices (relu1_2 .. relu5_3)
_TAPS = [1, 3, 6, 9, 12]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _prepare(params: Mapping, device=None) -> dict[str, torch.Tensor]:
    """npz-format dict (numpy or torch) -> tensors, conv weights as OIHW."""
    out = {}
    for k, x in params.items():
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        t = x.to(device=device, dtype=torch.float32)
        if k.startswith("conv") and k.endswith("_w"):
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t
    return out


def _vgg_features(p: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x: [N, 3, H, W] in [-1, 1]; p: prepared params."""
    shift = torch.tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
    h = (x - shift) / scale
    feats = []
    for i, (_, pool) in enumerate(_VGG16):
        if pool:
            h = F.max_pool2d(h, 2, 2)
        h = F.relu(F.conv2d(h, p[f"conv{i}_w"], p[f"conv{i}_b"], padding=1))
        if i in _TAPS:
            feats.append(h)
    return feats


def _distance(p: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dim() == 3:
        a, b = a[None], b[None]
    fa = _vgg_features(p, a.permute(0, 3, 1, 2) * 2.0 - 1.0)
    fb = _vgg_features(p, b.permute(0, 3, 1, 2) * 2.0 - 1.0)
    total = 0.0
    for i, (xa, xb) in enumerate(zip(fa, fb)):
        na = xa / torch.clamp(torch.linalg.norm(xa, dim=1, keepdim=True),
                              min=1e-10)
        nb = xb / torch.clamp(torch.linalg.norm(xb, dim=1, keepdim=True),
                              min=1e-10)
        w = p[f"lin{i}_w"].reshape(1, -1, 1, 1)  # non-negative per channel
        total = total + ((na - nb) ** 2 * w).sum(1).mean()
    return total


def lpips_distance(params: Mapping, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Mean LPIPS over a batch. a, b: [N, H, W, 3] or [H, W, 3] in [0, 1];
    ``params`` in the npz format."""
    return _distance(_prepare(params, a.device), a, b)


def convert_lpips_torch(vgg_state: Mapping, lin_state: Mapping) -> dict:
    """torchvision ``vgg16.features.*`` and lpips ``lin[0-4].model.1.weight``
    state dicts -> the npz-format parameter dict."""
    params = {}
    conv_idx = 0
    layer = 0
    while conv_idx < len(_VGG16) and layer <= 40:
        wkey = f"features.{layer}.weight"
        if wkey in vgg_state:
            w = np.asarray(vgg_state[wkey], np.float32)
            b = np.asarray(vgg_state[f"features.{layer}.bias"], np.float32)
            params[f"conv{conv_idx}_w"] = w.transpose(2, 3, 1, 0)  # ->HWIO
            params[f"conv{conv_idx}_b"] = b
            conv_idx += 1
        layer += 1
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin_state:
                params[f"lin{i}_w"] = np.asarray(lin_state[key],
                                                 np.float32).reshape(-1)
                break
    return params


def save_lpips(path: str, params: Mapping) -> None:
    np.savez_compressed(path, **{k: np.asarray(
        v.cpu() if isinstance(v, torch.Tensor) else v)
        for k, v in params.items()})


def load_lpips(path: str | None = None, device=None) -> Callable | None:
    """lpips(a, b) -> scalar, or None when no weights file is available."""
    if path is None:
        path = os.environ.get("SCT_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    data = np.load(path)
    p = _prepare({k: data[k] for k in data.files}, device)
    return lambda a, b: _distance(p, a, b)


def random_lpips_params(generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random-weight instance in the npz format, drawn on the CPU from
    ``generator`` (the same numbers on every device)."""
    params = {}
    cin = 3
    for i, (cout, _) in enumerate(_VGG16):
        params[f"conv{i}_w"] = torch.randn((3, 3, cin, cout),
                                           generator=generator) * 0.05
        params[f"conv{i}_b"] = torch.zeros((cout,))
        cin = cout
    for i, t in enumerate(_TAPS):
        params[f"lin{i}_w"] = F.softplus(
            torch.randn((_VGG16[t][0],), generator=generator)) * 0.01
    return params


def random_feature_lpips(seed: int = 0, device=None) -> Callable:
    """Seeded random-filter LPIPS stand-in (``optim.lpips_fallback``): the
    VGG16 topology with random convolutions, a usable perceptual-style
    distance but NOT the reference objective (its numbers differ from the
    JAX package's stand-in, whose filters come from jax.random)."""
    p = _prepare(random_lpips_params(torch.Generator().manual_seed(seed)),
                 device)
    return lambda a, b: _distance(p, a, b)

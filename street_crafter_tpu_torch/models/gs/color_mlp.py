"""Pose-conditioned colour-correction MLP (port of
``street_crafter_tpu/models/gs/color_mlp.py``).

A 4-layer MLP (6 -> 64 -> 64 -> 64 -> 12, the last layer zero-initialised)
maps the camera's world->camera extrinsic, rotation as axis-angle [3] plus
translation [3], to a residual [3, 4] affine added to identity. A second
MLP serves the sky. Parameters are a flat name -> tensor dict (``w0``,
``b0``, ...), so the trainer's per-leaf Adam and misc learning rates apply.
"""

from __future__ import annotations

import torch

from ...ops import quaternion as Q

DIMS = (6, 64, 64, 64, 12)


def init_color_mlp(generator: torch.Generator | None = None,
                   device: torch.device | str = "cpu"
                   ) -> dict[str, torch.Tensor]:
    """Xavier-uniform hidden layers drawn from ``generator``, a zero output
    layer, zero biases."""
    params = {}
    n = len(DIMS) - 1
    for i in range(n):
        fan_in, fan_out = DIMS[i], DIMS[i + 1]
        if i == n - 1:
            w = torch.zeros((fan_in, fan_out))
        else:
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            w = (torch.rand((fan_in, fan_out), generator=generator) * 2.0
                 - 1.0) * bound
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((fan_out,), device=device)
    return params


def apply_color_mlp(params: dict[str, torch.Tensor], w2c: torch.Tensor
                    ) -> torch.Tensor:
    """w2c [4, 4] -> affine [3, 4] (identity + the MLP's residual)."""
    aa = Q.to_axis_angle(Q.from_matrix(w2c[:3, :3]))
    x = torch.cat([aa, w2c[:3, 3]])
    n = len(DIMS) - 1
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    eye = torch.cat([torch.eye(3, device=x.device),
                     torch.zeros((3, 1), device=x.device)], 1)
    return x.reshape(3, 4) + eye

"""EDM diffusion math: scalings, discretisation and the guiders (port of
``street_crafter_tpu/models/vdm/diffusion.py``). D(x) = net(c_in x,
c_noise) c_out + x c_skip (denoiser.py:22-35) with the Vista V-scaling and
EDM c_noise. (``edm_sigma_sample`` and the loss weighting belong to
fine-tuning and are not ported here.)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Scaling(NamedTuple):
    c_skip: torch.Tensor
    c_out: torch.Tensor
    c_in: torch.Tensor
    c_noise: torch.Tensor


def v_scaling_edm_cnoise(sigma: torch.Tensor) -> Scaling:
    """VScalingWithEDMcNoise (denoiser_scaling.py:51-59)."""
    return Scaling(c_skip=1.0 / (sigma ** 2 + 1.0),
                   c_out=-sigma / torch.sqrt(sigma ** 2 + 1.0),
                   c_in=1.0 / torch.sqrt(sigma ** 2 + 1.0),
                   c_noise=0.25 * torch.log(sigma))


def edm_scaling(sigma: torch.Tensor, sigma_data: float = 0.5) -> Scaling:
    return Scaling(
        c_skip=sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2),
        c_out=sigma * sigma_data / torch.sqrt(sigma ** 2 + sigma_data ** 2),
        c_in=1.0 / torch.sqrt(sigma ** 2 + sigma_data ** 2),
        c_noise=0.25 * torch.log(sigma))


def eps_scaling(sigma: torch.Tensor) -> Scaling:
    return Scaling(c_skip=torch.ones_like(sigma), c_out=-sigma,
                   c_in=1.0 / torch.sqrt(sigma ** 2 + 1.0), c_noise=sigma)


def edm_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
               rho: float = 7.0, append_zero: bool = True,
               device=None) -> torch.Tensor:
    """EDMDiscretization (discretizer.py:26-37), f32."""
    ramp = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    min_r = sigma_min ** (1 / rho)
    max_r = sigma_max ** (1 / rho)
    sigmas = (max_r + ramp * (min_r - max_r)) ** rho
    if append_zero:
        sigmas = torch.cat([sigmas, sigmas.new_zeros(1)])
    return sigmas


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (target_ndim - x.dim()))


def denoise(model_fn: Callable, x: torch.Tensor, sigma: torch.Tensor,
            scaling_fn: Callable = v_scaling_edm_cnoise) -> torch.Tensor:
    """EDM-preconditioned denoiser D(x); the network output is taken to
    x's dtype."""
    s = scaling_fn(sigma)
    out = model_fn(x * append_dims(s.c_in, x.dim()), s.c_noise)
    return out.to(x.dtype) * append_dims(s.c_out, x.dim()) \
        + x * append_dims(s.c_skip, x.dim())


def vanilla_cfg(uncond: torch.Tensor, cond: torch.Tensor,
                scale: float) -> torch.Tensor:
    """VanillaCFG combine (guiders.py:23-26)."""
    return uncond + scale * (cond - uncond)


def linear_cfg(uncond, cond, max_scale: float, min_scale: float,
               num_frames: int) -> torch.Tensor:
    """LinearPredictionGuider (guiders.py:55-90)."""
    scale = torch.linspace(min_scale, max_scale, num_frames,
                           device=uncond.device)
    scale = scale.repeat(uncond.shape[0] // num_frames)
    return uncond + append_dims(scale, uncond.dim()) * (cond - uncond)


def triangle_cfg(uncond, cond, max_scale: float, min_scale: float,
                 num_frames: int) -> torch.Tensor:
    """TrianglePredictionGuider (guiders.py:93-129)."""
    half = (num_frames + 1) // 2
    up = torch.linspace(min_scale, max_scale, half, device=uncond.device)
    down = torch.linspace(max_scale, min_scale, num_frames - half + 1,
                          device=uncond.device)[1:]
    scale = torch.cat([up, down]).repeat(uncond.shape[0] // num_frames)
    return uncond + append_dims(scale, uncond.dim()) * (cond - uncond)

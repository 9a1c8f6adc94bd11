"""Euler EDM samplers, with the SDS partial-denoise variant (port of
``street_crafter_tpu/models/vdm/samplers.py``; sampling.py EulerEDMSampler
:94-126 and EulerEDMSamplerSDS :167-217). Each is a Python loop over the
steps; ``denoise_fn(x, sigma_vec) -> denoised`` already includes the CFG
combine and the conditioning.
"""

from __future__ import annotations

from typing import Callable

import torch

from .diffusion import append_dims


def to_d(x, sigma, denoised):
    return (x - denoised) / append_dims(sigma, x.dim())


def _replace_cond(x, cond_frame, cond_mask):
    if cond_mask is None or cond_frame is None:
        return x
    m = append_dims(cond_mask.to(x.dtype), x.dim())
    return x * (1 - m) + cond_frame * m


def _steps(denoise_fn, x, sigmas, first, cond_frame, cond_mask):
    for i in range(first, sigmas.shape[0] - 1):
        x = _replace_cond(x, cond_frame, cond_mask)
        sigma = sigmas[i].expand(x.shape[0])
        d = to_d(x, sigma, denoise_fn(x, sigma))
        x = x + d * (sigmas[i + 1] - sigmas[i])
    return _replace_cond(x, cond_frame, cond_mask)


def euler_edm_sample(denoise_fn: Callable, x: torch.Tensor,
                     sigmas: torch.Tensor,
                     cond_frame: torch.Tensor | None = None,
                     cond_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full Euler EDM loop. x is standard-normal noise, scaled by
    sqrt(1 + sigma_0^2) first (sampling.py:186-189)."""
    x = x * torch.sqrt(1.0 + sigmas[0] ** 2)
    return _steps(denoise_fn, x, sigmas, 0, cond_frame, cond_mask)


def euler_edm_sample_sds(denoise_fn: Callable, noise: torch.Tensor,
                         sigmas: torch.Tensor, render_latents: torch.Tensor,
                         scale: float,
                         cond_frame: torch.Tensor | None = None,
                         cond_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """SDS partial denoise: start at num_steps * (1 - scale) from the
    noised render latents."""
    num_steps = sigmas.shape[0] - 1
    start = num_steps - int(num_steps * scale)
    x = render_latents + noise * sigmas[start]
    return _steps(denoise_fn, x, sigmas, start, cond_frame, cond_mask)

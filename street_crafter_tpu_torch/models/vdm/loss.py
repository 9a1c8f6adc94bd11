"""Diffusion training loss (port of ``street_crafter_tpu/models/vdm/
loss.py``; StandardDiffusionLoss, vwm/modules/diffusionmodules/
loss.py:15-148).

Per-video EDM sigma, a random set of conditioning frames per video (choices
weighted 2^n), offset noise, sigma zeroed on the cond frames for the
noising only, V-weighting, and the StreetCrafter extras: the
temporal-difference re-weighting (no gradient through the weights) and the
0.1-weighted high-frequency term of the Fourier high-pass.

The random draws of one call are a ``LossDraws``: ``draw_loss`` makes them
from a ``torch.Generator``; a test builds one from the JAX package's draws
instead (the two generators never give the same numbers).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from .diffusion import append_dims, edm_sigma_sample, v_weighting

# reference training config: frame-0-only conditioning choices with
# exponential weights
DEFAULT_COND_CHOICES: Sequence[Sequence[int]] = ((), (0,), (0, 1), (0, 1, 2))


def cond_choices_table(num_frames: int,
                       choices: Sequence[Sequence[int]] = DEFAULT_COND_CHOICES
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(table [n, num_frames] of 0/1 cond-frame masks, probabilities [n]
    weighted 2^i) of the choices that leave a frame unconditioned
    (loss.py:73-81)."""
    kept = [c for c in choices if len(c) < num_frames
            and all(f < num_frames for f in c)]
    table = torch.zeros((len(kept), num_frames))
    for i, ch in enumerate(kept):
        for f in ch:
            table[i, f] = 1.0
    w = torch.tensor([2.0 ** i for i in range(len(kept))])
    return table, w / w.sum()


def sample_cond_mask(batch_size: int, num_frames: int,
                     choices: Sequence[Sequence[int]] = DEFAULT_COND_CHOICES,
                     generator: torch.Generator | None = None,
                     device=None) -> torch.Tensor:
    """A random cond-frame mask per video, [batch * num_frames]."""
    table, probs = cond_choices_table(num_frames, choices)
    idx = torch.multinomial(probs.to(device), batch_size, replacement=True,
                            generator=generator)
    return table.to(device)[idx].reshape(batch_size * num_frames)


def fourier_filter(x: torch.Tensor, scale: float = 0.0,
                   d_s: float = 0.25) -> torch.Tensor:
    """High-pass in Fourier space (util.py:20-43): on the fftshift'd
    spectrum, every bin whose normalised radius squared from the centre,
    (2h/H - 1)^2 + (2w/W - 1)^2, is <= 2 d_s is scaled by ``scale``.
    x: [N, H, W, C]."""
    H, W = x.shape[1], x.shape[2]
    freq = torch.fft.fftn(x.float(), dim=(1, 2))
    freq = torch.fft.fftshift(freq, dim=(1, 2))
    yy = (2.0 * torch.arange(H, device=x.device)[:, None] / H - 1.0) ** 2
    xx = (2.0 * torch.arange(W, device=x.device)[None, :] / W - 1.0) ** 2
    mask = torch.where((yy + xx) <= 2.0 * d_s, scale, 1.0)
    freq = torch.fft.ifftshift(freq * mask[None, :, :, None], dim=(1, 2))
    return torch.fft.ifftn(freq, dim=(1, 2)).real.to(x.dtype)


class LossDraws(NamedTuple):
    """The random numbers of one ``diffusion_loss`` call."""
    sigma_normal: torch.Tensor     # [batch] standard normals -> log sigma
    cond_mask: torch.Tensor        # [batch * T] 0/1
    noise: torch.Tensor            # latents' shape, standard normal
    offset: torch.Tensor           # [batch * T, C] standard normal


def draw_loss(latents_shape, num_frames: int,
              generator: torch.Generator | None = None, device=None
              ) -> LossDraws:
    """The draws of one call for latents of ``latents_shape`` ([B*T, ...]),
    cond frames from ``DEFAULT_COND_CHOICES``."""
    n = latents_shape[0]
    bs = n // num_frames
    sig = torch.randn((bs,), generator=generator, device=device)
    mask = sample_cond_mask(bs, num_frames, generator=generator,
                            device=device)
    noise = torch.randn(tuple(latents_shape), generator=generator,
                        device=device)
    offset = torch.randn((n, latents_shape[-1]), generator=generator,
                         device=device)
    return LossDraws(sig, mask, noise, offset)


def diffusion_loss(
    denoise_fn: Callable,          # (noised_x, sigma, cond_mask) -> D(x)
    latents: torch.Tensor,         # [B*T, h, w, 4] clean VAE latents
    draws: LossDraws,
    num_frames: int = 25,
    p_mean: float = 1.0,
    p_std: float = 1.6,
    offset_noise_level: float = 0.02,
    use_additional_loss: bool = False,
    additional_loss_weight: float = 0.1,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The loss of a batch of whole clips: the mean over clips of each
    clip's loss (the JAX package maps the loss over the clips and means)."""
    n = latents.shape[0]
    bs = n // num_frames
    latents = latents.float()
    sigmas = edm_sigma_sample((n,), p_mean, p_std, num_frames,
                              normal=draws.sigma_normal)
    cond_mask = draws.cond_mask.float()
    noise = draws.noise.float()
    if offset_noise_level > 0:
        noise = noise + offset_noise_level * draws.offset.float()[:, None,
                                                                  None, :]
    noised = latents + noise * append_dims((1 - cond_mask) * sigmas,
                                           latents.dim())
    model_out = denoise_fn(noised, sigmas, cond_mask)

    cm = append_dims(cond_mask, latents.dim())
    predict = model_out * (1 - cm) + latents * cm   # ignore cond frames
    w = append_dims(v_weighting(sigmas), latents.dim())
    per_sample = (w * (predict - latents) ** 2).reshape(n, -1)

    if not use_additional_loss:
        loss = per_sample.mean(dim=1).mean()
        return loss, {"loss": loss, "sigma_mean": sigmas.mean()}
    # temporal-difference re-weighting (loss.py:106-118)
    with torch.no_grad():
        pr = predict.reshape(bs, num_frames, *predict.shape[1:])
        ta = latents.reshape(bs, num_frames, *latents.shape[1:])
        aux = ((ta[:, 1:] - ta[:, :-1]) - (pr[:, 1:] - pr[:, :-1])) ** 2
        flat = aux.reshape(bs, -1, aux.shape[-1])
        norm = torch.sqrt((flat ** 2).sum(dim=1, keepdim=True)) + 1e-12
        aux_w = (flat / norm).reshape(aux.shape)
        aux_w = 1.0 + torch.cat([torch.zeros_like(aux_w[:, :1]), aux_w],
                                dim=1)
        aux_w = aux_w.reshape(n, -1)
    per_sample = per_sample * aux_w
    # high-frequency loss (loss.py:119-121)
    hf = (w * (fourier_filter(predict) - fourier_filter(latents)) ** 2
          ).reshape(n, -1).mean(dim=1).mean()
    loss = per_sample.mean(dim=1).mean() + additional_loss_weight * hf
    return loss, {"loss": loss, "hf_loss": hf, "sigma_mean": sigmas.mean()}

"""Image losses and metrics: SSIM (11x11 Gaussian window), PSNR, masked L1/L2
(port of ``street_crafter_tpu/ops/ssim.py``).

Same constants as the reference's loss_utils (window 11, sigma 1.5,
C1 = 0.01^2, C2 = 0.03^2) and the same zero-padded SAME filter, applied
separably: one depthwise ``F.conv2d`` along each axis over all five filtered
maps at once. The public functions take the JAX package's [H, W, C] layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_1d_np(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter_sep(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian filter of channel-major [C, H, W], SAME zero pad."""
    C = img.shape[0]
    g = torch.tensor(_gaussian_1d_np(size, sigma), device=img.device)
    r = size // 2
    x = F.conv2d(img[None], g.reshape(1, 1, size, 1).expand(C, 1, size, 1),
                 padding=(r, 0), groups=C)
    x = F.conv2d(x, g.reshape(1, 1, 1, size).expand(C, 1, 1, size),
                 padding=(0, r), groups=C)
    return x[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, mask: torch.Tensor | None = None
         ) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] pair (values in [0, 1]); an optional
    [H, W, 1] mask takes the masked mean of the SSIM map."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    a = img1.permute(2, 0, 1)
    b = img2.permute(2, 0, 1)
    C = a.shape[0]
    mu1, mu2, aa, bb, ab = _filter_sep(
        torch.cat([a, b, a * a, b * b, a * b]), window_size, sigma).split(C)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = aa - mu1_sq
    s2 = bb - mu2_sq
    s12 = ab - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    ssim_map = ssim_map.permute(1, 2, 0)
    if mask is not None:
        m = mask.expand(ssim_map.shape)
        return (ssim_map * m).sum() / torch.clamp(m.sum(), min=1.0)
    return ssim_map.mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    if mask is not None:
        diff2 = ((img1 - img2) ** 2) * mask
        mse = diff2.sum() / torch.clamp(mask.sum() * img1.shape[-1], min=1.0)
    else:
        mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-10)))


def _masked_mean(d: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return d.mean()
    d = d * mask
    per = d.shape[-1] if mask.shape != d.shape else 1.0
    return d.sum() / torch.clamp(mask.sum() * per, min=1.0)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_mean((pred - gt).abs(), mask)


def l2_loss(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_mean((pred - gt) ** 2, mask)

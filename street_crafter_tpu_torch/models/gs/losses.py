"""Training-loss assembly (port of ``street_crafter_tpu/models/gs/losses.py``).

Mirrors the loss stack of the reference train loop:
- regular views: masked L1 + D-SSIM (+ LPIPS), sky entropy against the sky
  mask, object-acc entropy against the object-bound mask, best-95% LiDAR
  depth L1, scale-flatten and colour-correction regularisers;
- novel (diffusion-supervised) views: the same photometric trio on the
  lower 60% of the image, scaled by lambda_novel*.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ...ops.ssim import l1_loss, ssim


class LossWeights(NamedTuple):
    lambda_l1: float = 1.0
    lambda_dssim: float = 0.2
    lambda_lpips: float = 0.0
    lambda_sky: float = 0.0
    lambda_reg: float = 0.0
    lambda_depth_lidar: float = 0.0
    lambda_scale_flatten: float = 0.0
    lambda_color_correction: float = 0.0
    lambda_novel: float = 0.1
    lambda_novel_l1: float = 0.1
    lambda_novel_dssim: float = 0.1
    lambda_novel_lpips: float = 1.0


def photometric_loss(image, gt, mask, l1_w, dssim_w, lpips_w,
                     lpips_fn: Callable | None = None):
    ll1 = l1_loss(image, gt, mask)
    ssim_v = ssim(image, gt, mask=mask)
    loss = (1.0 - dssim_w) * l1_w * ll1 + dssim_w * (1.0 - ssim_v)
    scalars = {"l1": ll1, "ssim": ssim_v}
    if lpips_fn is not None and lpips_w > 0:
        lp = lpips_fn(image * mask, gt * mask)
        loss = loss + lpips_w * lp
        scalars["lpips"] = lp
    return loss, scalars


def _entropy(acc: torch.Tensor) -> torch.Tensor:
    return -(acc * torch.log(acc) + (1 - acc) * torch.log(1 - acc))


def sky_entropy_loss(acc: torch.Tensor, sky_mask: torch.Tensor
                     ) -> torch.Tensor:
    """-log(1-acc) inside the sky, binary entropy elsewhere."""
    acc = torch.clamp(acc, 1e-6, 1.0 - 1e-6)
    return torch.where(sky_mask, -torch.log(1 - acc), _entropy(acc)).mean()


def obj_acc_entropy_loss(acc_obj: torch.Tensor, obj_bound: torch.Tensor
                         ) -> torch.Tensor:
    """Entropy inside the object bound, -log(1-acc) outside."""
    acc = torch.clamp(acc_obj, 1e-6, 1.0 - 1e-6)
    return torch.where(obj_bound, _entropy(acc), -torch.log(1 - acc)).mean()


def lidar_depth_loss(depth: torch.Tensor, lidar_depth: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """L1 on the best 95% of valid LiDAR pixels: the largest 5% of errors
    (moving objects, mismatches) fall above a quantile threshold."""
    m = (lidar_depth > 0.0) & mask
    err = (depth - lidar_depth).abs()
    with torch.no_grad():
        q = torch.nanquantile(torch.where(m, err, torch.nan), 0.95)
    keep = m & (err <= q)
    return (torch.where(keep, err, 0.0).sum()
            / torch.clamp(keep.sum(), min=1.0))


def scale_flatten_loss(scaling: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """Disk-like Gaussians: mean min-scale plus the anisotropy of the two
    largest scales."""
    n = torch.clamp(valid.sum(), min=1.0)
    smin = scaling.amin(-1)
    top2 = torch.topk(scaling, 2, dim=-1).values
    aniso = (top2 ** 2).sum(-1) / torch.clamp(top2.prod(-1), min=1e-12) - 2.0
    return (torch.where(valid, smin, 0.0).sum()
            + torch.where(valid, aniso, 0.0).sum()) / n


def color_correction_reg(color_corr: torch.Tensor,
                         color_corr_sky: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """L1 identity regulariser on the affine colour matrices (and the sky
    set when present)."""
    eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1).to(color_corr)
    reg = (color_corr - eye).abs().mean()
    if color_corr_sky is not None:
        reg = reg + (color_corr_sky - eye).abs().mean()
    return reg


def compute_train_loss(
    render_out: dict[str, Any],
    batch: dict[str, Any],
    weights: LossWeights,
    is_novel: bool = False,
    lpips_fn: Callable | None = None,
    scene_scaling: torch.Tensor | None = None,
    scene_valid: torch.Tensor | None = None,
    color_corr: torch.Tensor | None = None,
    color_corr_sky: torch.Tensor | None = None,
    acc_obj: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    image = render_out["rgb"]
    gt = batch["gt_image"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(gt.shape[:2] + (1,), dtype=torch.float32,
                          device=gt.device)

    scalars: dict[str, torch.Tensor] = {}
    if is_novel:
        # only the lower 60% of a novel view is supervised
        upper = int(gt.shape[0] * 0.4)
        loss, ph = photometric_loss(
            image[upper:], gt[upper:], mask[upper:], weights.lambda_novel_l1,
            weights.lambda_novel_dssim, weights.lambda_novel_lpips, lpips_fn)
        loss = loss * weights.lambda_novel
        scalars.update({f"novel_{k}": v for k, v in ph.items()})
        scalars["loss"] = loss
        return loss, scalars

    loss, ph = photometric_loss(
        image, gt, mask, weights.lambda_l1, weights.lambda_dssim,
        weights.lambda_lpips, lpips_fn)
    scalars.update(ph)

    if weights.lambda_sky > 0 and "sky_mask" in batch:
        sky = sky_entropy_loss(render_out["acc"], batch["sky_mask"][..., 0])
        loss = loss + weights.lambda_sky * sky
        scalars["sky_loss"] = sky

    if weights.lambda_reg > 0 and acc_obj is not None and "obj_bound" in batch:
        ol = obj_acc_entropy_loss(acc_obj, batch["obj_bound"][..., 0])
        loss = loss + weights.lambda_reg * ol
        scalars["obj_acc_loss"] = ol

    if weights.lambda_depth_lidar > 0 and "lidar_depth" in batch:
        dl = lidar_depth_loss(render_out["depth"],
                              batch["lidar_depth"][..., 0], mask[..., 0] > 0)
        loss = loss + weights.lambda_depth_lidar * dl
        scalars["lidar_depth_loss"] = dl

    if weights.lambda_scale_flatten > 0 and scene_scaling is not None:
        sl = scale_flatten_loss(scene_scaling, scene_valid)
        loss = loss + weights.lambda_scale_flatten * sl
        scalars["scale_flatten_loss"] = sl

    if weights.lambda_color_correction > 0 and color_corr is not None:
        cl = color_correction_reg(color_corr, color_corr_sky)
        loss = loss + weights.lambda_color_correction * cl
        scalars["color_correction_loss"] = cl

    scalars["loss"] = loss
    return loss, scalars

"""OpenCLIP ViT visual tower, the image embedder (port of
``street_crafter_tpu/models/vdm/clip.py``).

State-dict names are open_clip's ``visual.*`` (conv1, class_embedding,
positional_embedding, ln_pre, transformer.resblocks.{i}.{ln_1, attn.
in_proj_weight / in_proj_bias / out_proj, ln_2, mlp.c_fc, mlp.c_proj},
ln_post, proj). As in the JAX package: LayerNorm eps 1e-6, the exact (erf)
GELU, q scaled by 1/sqrt(head dim) before the product.

``clip_preprocess`` resizes with the Keys cubic kernel (a = -0.5) and
antialiasing when downsampling, the same weights as
``jax.image.resize(..., "bicubic")``, written as two weight-matrix products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv, layer_norm, linear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisualConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    output_dim: int = 1024
    dtype: Optional[str] = None     # compute dtype; None = float32

    @staticmethod
    def tiny() -> "CLIPVisualConfig":
        return CLIPVisualConfig(image_size=32, patch_size=8, width=32,
                                layers=2, heads=2, output_dim=48)


class _Attention(nn.Module):
    """nn.MultiheadAttention's parameters (packed q/k/v in_proj)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        n, s, w = x.shape
        hd = w // self.heads
        wt = self.in_proj_weight
        qkv = F.linear(x.to(wt.dtype), wt, self.in_proj_bias)
        q, k, v = (t.reshape(n, s, self.heads, hd)
                   for t in qkv.chunk(3, dim=-1))
        q = q / torch.tensor(hd ** 0.5, dtype=q.dtype, device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(n, s, w)
        return linear(out, self.out_proj)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(width, width * 4)
        self.mlp.c_proj = nn.Linear(width * 4, width)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, self.ln_1))
        h = linear(layer_norm(x, self.ln_2), self.mlp.c_fc)
        return x + linear(F.gelu(h), self.mlp.c_proj)


class CLIPVisual(nn.Module):
    def __init__(self, cfg: CLIPVisualConfig = CLIPVisualConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                               bias=False)
        n_tok = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(n_tok + 1, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(w, cfg.heads) for _ in range(cfg.layers)])
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.zeros(w, cfg.output_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] preprocessed images -> [N, output_dim]."""
        n = images.shape[0]
        x = conv(images.permute(0, 3, 1, 2), self.conv1)
        x = x.flatten(2).transpose(1, 2)                     # [N, tokens, W]
        cls = self.class_embedding.to(x.dtype).expand(n, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = layer_norm(x, self.ln_pre)
        for blk in self.transformer.resblocks:
            x = blk(x)
        x = layer_norm(x[:, 0], self.ln_post)
        return x @ self.proj.to(x.dtype)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of a Keys-cubic resize, antialiased when
    downsampling (jax/_src/image/scale.py compute_weight_mat)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(images: torch.Tensor, height: int, width: int
                   ) -> torch.Tensor:
    """[N, H, W, C] f32 -> [N, height, width, C], Keys cubic (a = -0.5)
    with antialiasing, as ``jax.image.resize(..., "bicubic")``."""
    _, H, W, _ = images.shape
    wy = _resize_weights(H, height, images.device)
    wx = _resize_weights(W, width, images.device)
    return torch.einsum("nhwc,hy,wx->nyxc", images.float(), wy, wx)


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[-1, 1] images [N, H, W, 3] -> normalised [N, size, size, 3]."""
    x = resize_bicubic((images.float() + 1.0) / 2.0, size, size)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std

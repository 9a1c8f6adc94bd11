"""SD VAE (f8, z 4) encoder and the temporal VideoDecoder (port of
``street_crafter_tpu/models/vdm/vae.py``).

State-dict names are the reference's (model.py:445-694, temporal_ae.py:
75-151): ``encoder.*`` / ``decoder.*`` with ``down.{l}.block.{i}``,
``mid.block_1`` / ``mid.attn_1``, ``up.{l}.block.{i}``, and in the video
decoder each ResnetBlock's ``time_stack`` and ``mix_factor`` and
``conv_out.time_mix_conv``. GroupNorm eps is 1e-6 everywhere, as in the
JAX package. The public calls are channels-last, [N, H, W, C].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv, group_norm, upsample_nearest, zero_

GN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    out_ch: int = 3
    double_z: bool = True
    video_kernel_size: Sequence[int] = (3, 1, 1)
    scale_factor: float = 0.18215
    dtype: Optional[str] = None     # compute dtype; None = float32

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1)


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=GN_EPS)


class ResnetBlock(nn.Module):
    """model.py ResnetBlock (no time embedding in the autoencoder)."""

    def __init__(self, ch: int, out_ch: int | None = None):
        super().__init__()
        out_ch = out_ch or ch
        self.norm1 = _gn(ch)
        self.conv1 = nn.Conv2d(ch, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(ch, out_ch, 1) if out_ch != ch else None

    def forward(self, x):
        h = conv(F.silu(group_norm(x, self.norm1, GN_EPS)), self.conv1)
        h = conv(F.silu(group_norm(h, self.norm2, GN_EPS)), self.conv2)
        if self.nin_shortcut is not None:
            x = conv(x, self.nin_shortcut)
        return x + h


class TemporalResBlock(nn.Module):
    """3D ResBlock without time embedding (openaimodel ResBlock dims 3,
    skip_t_emb) on [B, C, T, H, W]; the second conv is zero-initialised."""

    def __init__(self, ch: int, kernel_size=(3, 1, 1)):
        super().__init__()
        ks = tuple(kernel_size)
        pad = tuple(k // 2 for k in ks)
        self.in_layers = nn.Sequential(_gn(ch), nn.SiLU(),
                                       nn.Conv3d(ch, ch, ks, padding=pad))
        self.out_layers = nn.Sequential(
            _gn(ch), nn.SiLU(), nn.Dropout(0.0),
            zero_(nn.Conv3d(ch, ch, ks, padding=pad)))

    def forward(self, x):
        h = conv(F.silu(group_norm(x, self.in_layers[0], GN_EPS)),
                 self.in_layers[2])
        h = conv(F.silu(group_norm(h, self.out_layers[0], GN_EPS)),
                 self.out_layers[3])
        return x + h


class VideoResnetBlock(ResnetBlock):
    """ResnetBlock + temporal ResBlock mixed by sigmoid(mix_factor) (on the
    temporal branch, as the JAX package writes it)."""

    def __init__(self, ch: int, out_ch: int | None = None,
                 video_kernel_size=(3, 1, 1), alpha: float = 0.0):
        super().__init__(ch, out_ch)
        self.time_stack = TemporalResBlock(out_ch or ch, video_kernel_size)
        self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def forward(self, x, num_frames: int):
        x = super().forward(x)
        bt, c, hh, ww = x.shape
        b = bt // num_frames
        x5 = x.reshape(b, num_frames, c, hh, ww).transpose(1, 2)
        h = self.time_stack(x5)
        a = torch.sigmoid(self.mix_factor)[0].to(h.dtype)
        out = a * h + (1.0 - a) * x5.to(h.dtype)
        return out.transpose(1, 2).reshape(bt, c, hh, ww)


class AttnBlock(nn.Module):
    """Single-head attention over all positions (model.py AttnBlock). Runs
    one image at a time: at 72 x 128 latents the f32 scores are 340 MB per
    image."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        N, C, H, W = x.shape
        outs = []
        for i in range(N):
            h = group_norm(x[i:i + 1], self.norm, GN_EPS)
            q, k, v = (conv(h, m).reshape(C, H * W)
                       for m in (self.q, self.k, self.v))
            attn = torch.softmax((q.float().t() @ k.float()) * C ** -0.5,
                                 dim=-1)
            o = (attn.to(v.dtype).float() @ v.float().t()).to(v.dtype)
            outs.append(o.t().reshape(1, C, H, W))
        h = conv(torch.cat(outs), self.proj_out)
        return x.to(h.dtype) + h


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.ch
        self.conv_in = nn.Conv2d(3, c, 3, padding=1)
        self.down = nn.ModuleList()
        for level, mult in enumerate(cfg.ch_mult):
            lv = _Level()
            for _ in range(cfg.num_res_blocks):
                lv.block.append(ResnetBlock(c, cfg.ch * mult))
                c = cfg.ch * mult
            if level != len(cfg.ch_mult) - 1:
                lv.downsample = nn.Module()
                lv.downsample.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)
            self.down.append(lv)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(c)
        self.mid.attn_1 = AttnBlock(c)
        self.mid.block_2 = ResnetBlock(c)
        self.norm_out = _gn(c)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(c, out_c, 3, padding=1)

    def forward(self, x):
        """[N, 3, H, W] -> moments [N, 2z, H/f, W/f]."""
        h = conv(x, self.conv_in)
        for level, lv in enumerate(self.down):
            for blk in lv.block:
                h = blk(h)
            if level != len(self.down) - 1:
                # asymmetric pad (0, 1) then a stride-2 conv (Downsample)
                h = conv(F.pad(h, (0, 1, 0, 1)), lv.downsample.conv)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        h = F.silu(group_norm(h, self.norm_out, GN_EPS))
        return conv(h, self.conv_out)


class AE3DConv(nn.Conv2d):
    """conv_out of the video decoder: a 2D conv, then a (3, 1, 1) conv over
    time replacing its output (temporal_ae.py AE3DConv)."""

    def __init__(self, in_ch: int, out_ch: int, video_kernel_size=(3, 1, 1)):
        super().__init__(in_ch, out_ch, 3, padding=1)
        ks = tuple(video_kernel_size)
        self.time_mix_conv = nn.Conv3d(out_ch, out_ch, ks,
                                       padding=tuple(k // 2 for k in ks))

    def forward(self, x, num_frames: int):
        h = conv(x, self)
        bt, c, hh, ww = h.shape
        h5 = h.reshape(bt // num_frames, num_frames, c, hh, ww).transpose(1, 2)
        h5 = conv(h5, self.time_mix_conv)
        return h5.transpose(1, 2).reshape(bt, c, hh, ww)


class VideoDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        vk = tuple(cfg.video_kernel_size)
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, c, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = VideoResnetBlock(c, c, vk)
        self.mid.attn_1 = AttnBlock(c)
        self.mid.block_2 = VideoResnetBlock(c, c, vk)
        levels = [None] * len(cfg.ch_mult)
        for level, mult in list(enumerate(cfg.ch_mult))[::-1]:
            lv = _Level()
            for _ in range(cfg.num_res_blocks + 1):
                lv.block.append(VideoResnetBlock(c, cfg.ch * mult, vk))
                c = cfg.ch * mult
            if level != 0:
                lv.upsample = nn.Module()
                lv.upsample.conv = nn.Conv2d(c, c, 3, padding=1)
            levels[level] = lv
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(c)
        self.conv_out = AE3DConv(c, cfg.out_ch, vk)

    def forward(self, z, num_frames: int):
        """[N, z, h, w] -> images [N, 3, 8h, 8w]."""
        h = conv(z, self.conv_in)
        h = self.mid.block_1(h, num_frames)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, num_frames)
        for level in reversed(range(len(self.up))):
            lv = self.up[level]
            for blk in lv.block:
                h = blk(h, num_frames)
            if level != 0:
                h = conv(upsample_nearest(h), lv.upsample.conv)
        h = F.silu(group_norm(h, self.norm_out, GN_EPS))
        return self.conv_out(h, num_frames)


def diagonal_gaussian_sample(moments: torch.Tensor,
                             noise: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """DiagonalGaussianRegularizer on channels-last moments: the mode, or a
    sample with the given standard-normal noise."""
    mean, logvar = moments.chunk(2, dim=-1)
    if noise is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * noise


class VAE(nn.Module):
    """Encoder + video decoder + scale factor (AutoencodingEngine)."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = VideoDecoder(cfg)

    def encode(self, x: torch.Tensor,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """images [N, H, W, 3] in [-1, 1] -> scaled latents [N, h, w, z]."""
        moments = self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return diagonal_gaussian_sample(moments, noise) * self.cfg.scale_factor

    def decode(self, z: torch.Tensor, num_frames: int = 1) -> torch.Tensor:
        """scaled latents [N, h, w, z] -> images [N, H, W, 3]."""
        out = self.decoder((z / self.cfg.scale_factor).permute(0, 3, 1, 2),
                           num_frames)
        return out.permute(0, 2, 3, 1)

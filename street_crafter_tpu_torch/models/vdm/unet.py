"""SVD/Vista VideoUNet with the StreetCrafter conditioning deltas (port of
``street_crafter_tpu/models/vdm/unet.py``).

The SVD U-Net (channels 320 x (1, 2, 4, 4), attention at ds 1/2/4, head dim
64, context 1024, in 8 = 4 noise + 4 concat cond-frame channels) plus the two
StreetCrafter additions: ``cond_time_stack_embed``, a second timestep MLP
selected per frame by cond_mask, and ``condition_input_blocks``, two convs
(the second zero-initialised) that add the VAE-encoded LiDAR-condition
latents, scaled per frame, to the first input block's output.

State-dict names are the reference's (video_model.py:83-535). The public
call is channels-last, [B*T, H, W, C], as in the JAX package; with a
``frames`` shard (sequence parallelism, ``parallel/sequence.py``) T is this
rank's T/f frames of each clip and the blocks exchange what crosses
frames.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from ...ops.flash_attention import SiteStore
from ...parallel.sequence import FramesShard
from .layers import (GN_EPS, Downsample, MLPEmbed, SpatialVideoTransformer,
                     Upsample, VideoResBlock, conv, group_norm,
                     timestep_embedding, zero_)

REMAT_POLICIES = ("flash0", "nothing", "flash", "flash01", "flashx", "dots")
# the 2-D matrix products a "dots" checkpoint keeps: every Linear (flattened
# to [rows, in] x [in, out]); no bmm (attention einsums), no convolution
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of products without batch dimensions, recompute the
    rest."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Hyper-parameters (configs/inference/waymo_high_res.yaml:20-41).
    ``remat``: activation checkpointing of every VideoResBlock and
    SpatialVideoTransformer while gradients are recorded (the reference
    trains with use_checkpoint: True). ``remat_policy``, what the
    checkpoint keeps from its forward for the recompute (the JAX package's
    ``unet.py:137-160``): "nothing" keeps nothing; "flash0" the outputs
    and logsumexp of the level-0 flash sites, "flash01" those of levels 0
    and 1, "flash" those of levels 0-2; "flashx" those of levels 0 and 1
    and the outputs of the temporal attention at q length T and the
    model's width (JAX's ``attn_out_q{T}_c{mc}``); "dots" the outputs of
    the 2-D matrix products (every Linear), and no flash site."""
    in_channels: int = 8
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    adm_in_channels: int = 768
    video_kernel_size: Sequence[int] = (3, 1, 1)
    merge_strategy: str = "learned_with_images"
    merge_factor: float = 0.5
    use_spatial_context: bool = True
    add_lora: bool = False
    lora_rank: int = 16
    remat: bool = True
    remat_policy: str = "flash0"
    dtype: Optional[str] = None     # compute dtype; None = float32
    fused_temporal: bool = False
    # W8A8 int8 for the 2-D 3x3 ResBlock / Downsample / Upsample
    # convolutions (layers.quant_conv, kernel Q): eval only
    quant_convs: bool = False

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(model_channels=32, num_head_channels=16,
                          channel_mult=(1, 2), attention_resolutions=(2,),
                          context_dim=48, adm_in_channels=24)


class VideoUNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed = MLPEmbed(mc, ted, ted)
        self.cond_time_stack_embed = MLPEmbed(mc, ted, ted)
        self.label_emb = nn.Sequential(MLPEmbed(cfg.adm_in_channels, ted, ted))

        def attn(ch):
            return SpatialVideoTransformer(
                ch, ch // cfg.num_head_channels, cfg.num_head_channels,
                cfg.transformer_depth, cfg.context_dim,
                use_spatial_context=cfg.use_spatial_context,
                merge_factor=cfg.merge_factor, add_lora=cfg.add_lora,
                fused_temporal=cfg.fused_temporal,
                merge_strategy=cfg.merge_strategy)

        def res(ch, out_ch):
            return VideoResBlock(ch, ted, out_ch, cfg.video_kernel_size,
                                 cfg.merge_factor, cfg.merge_strategy,
                                 quant_convs=cfg.quant_convs)

        self.input_blocks = nn.ModuleList([nn.ModuleList(
            [nn.Conv2d(cfg.in_channels, mc, 3, padding=1)])])
        self.condition_input_blocks = nn.ModuleList([
            nn.ModuleList([nn.Conv2d(cfg.in_channels // 2, mc, 3,
                                     padding=1)]),
            nn.ModuleList([zero_(nn.Conv2d(mc, mc, 3, padding=1))])])
        ch, ds = mc, 1
        chans = [mc]
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                mods = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    mods.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(mods))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(
                    ch, quant_convs=cfg.quant_convs)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch),
                                           res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                mods = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    mods.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    mods.append(Upsample(ch, quant_convs=cfg.quant_convs))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(mods))
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 zero_(nn.Conv2d(ch, cfg.out_channels, 3,
                                                 padding=1)))

    def _block_runner(self, height: int, width: int, num_frames: int):
        """How each res / transformer block runs: directly, or under
        ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat`` and
        gradients are recorded. The flash policies' checkpoints keep the
        flash sites at the chosen levels' sequence lengths (level L: the
        latent's ceil(H / 2^L) * ceil(W / 2^L)), and "flashx" also the
        temporal attention sites of q length T and width mc, and their
        recompute reuses them (``ops.flash_attention.SiteStore``), as the
        JAX package saves ``flash_out_s{S}``, ``flash_lse_s{S}`` and
        ``attn_out_q{T}_c{mc}``; "dots" selects what it keeps by operator
        (``_dots_policy``). ``num_frames`` is the clip's T (the temporal
        attention's query length, also under sequence parallelism). A
        block's recompute issues its exchanges again: every rank of a frames
        group recomputes the same blocks in the same order."""
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return lambda m, *args: m(*args)
        policy = cfg.remat_policy
        if policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {policy!r}: one of "
                             f"{REMAT_POLICIES}")
        if policy == "nothing":
            return lambda m, *args: checkpoint(m, *args, use_reentrant=False)
        if policy == "dots":
            return lambda m, *args: checkpoint(
                m, *args, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _dots_policy))
        levels = {"flash0": 1, "flash01": 2, "flashx": 2, "flash": 3}[policy]
        seq = [-(-height // (1 << lv)) * -(-width // (1 << lv))
               for lv in range(levels)]
        temporal = ([(num_frames, cfg.model_channels)]
                    if policy == "flashx" else [])
        return lambda m, *args: checkpoint(
            m, *args, use_reentrant=False,
            context_fn=lambda: SiteStore(seq, temporal).contexts())

    def forward(
        self,
        x: torch.Tensor,                  # [B*T, H, W, in_channels]
        timesteps: torch.Tensor,          # [B*T]
        context: torch.Tensor,            # [B or B*T, S_ctx, context_dim]
        y: torch.Tensor,                  # [B or B*T, adm_in_channels]
        num_frames: int,
        cond_mask: Optional[torch.Tensor] = None,       # [B*T]
        guidance_input: Optional[torch.Tensor] = None,  # [B*T, H, W, in/2]
        guidance_scale: Optional[torch.Tensor] = None,  # [B*T] or scalar
        frames: Optional[FramesShard] = None,
    ) -> torch.Tensor:
        """-> [B*T, H, W, out_channels] in the compute dtype. With
        ``frames``, T = ``num_frames`` is this rank's share of each clip
        (``frames.local``) and every per-frame input holds its frames."""
        mc = self.cfg.model_channels
        t_emb = timestep_embedding(timesteps, mc)
        emb = self.time_embed(t_emb)
        if cond_mask is not None:
            cm = cond_mask.to(emb.dtype)[:, None]
            emb = self.cond_time_stack_embed(t_emb) * cm + emb * (1 - cm)
        if context.shape[0] != x.shape[0]:
            context = context.repeat_interleave(num_frames, dim=0)
        if y.shape[0] != x.shape[0]:
            y = y.repeat_interleave(num_frames, dim=0)
        emb = emb + self.label_emb[0](y)
        dtype = self.input_blocks[0][0].weight.dtype
        context = context.to(dtype)

        if frames is not None and frames.local != num_frames:
            raise ValueError(f"{num_frames} frames a clip on a rank of a "
                             f"{frames.num_frames}-frame clip over "
                             f"{frames.size} frames ranks")
        block = self._block_runner(
            x.shape[1], x.shape[2],
            num_frames if frames is None else frames.num_frames)

        def run(mods, h):
            for m in mods:
                if isinstance(m, VideoResBlock):
                    h = block(m, h, emb, num_frames, frames)
                elif isinstance(m, SpatialVideoTransformer):
                    h = block(m, h, context, num_frames, frames)
                else:                       # Downsample, Upsample
                    h = m(h, frames)
            return h

        h = conv(x.permute(0, 3, 1, 2), self.input_blocks[0][0])
        if guidance_input is not None:
            g = conv(guidance_input.permute(0, 3, 1, 2),
                     self.condition_input_blocks[0][0])
            g = conv(g, self.condition_input_blocks[1][0])
            scale = torch.ones((), dtype=h.dtype, device=h.device) \
                if guidance_scale is None \
                else torch.as_tensor(guidance_scale, device=h.device).to(
                    h.dtype)
            # [B*T] -> [B*T, 1, 1, 1] on NCHW (channels-last: last dims)
            while scale.dim() and scale.dim() < g.dim():
                scale = scale[..., None]
            h = h + g * scale
        hs = [h]
        for mods in list(self.input_blocks)[1:]:
            h = run(mods, h)
            hs.append(h)
        h = run(self.middle_block, h)
        for mods in self.output_blocks:
            h = run(mods, torch.cat([h, hs.pop()], dim=1))
        h = F.silu(group_norm(h, self.out[0], GN_EPS))
        return conv(h, self.out[2]).permute(0, 2, 3, 1)

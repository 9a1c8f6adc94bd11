"""Building blocks of the video diffusion UNet (port of
``street_crafter_tpu/models/vdm/layers.py``).

Modules hold the reference's torch state-dict names (openaimodel /
video_model / attention / video_attention), so a torch checkpoint loads
without a name map. Semantics follow the JAX package, not the upstream
torch modules where the two differ:
  * LayerNorm eps 1e-6 (flax's default), GroupNorm eps 1e-5 in ResBlocks and
    1e-6 in the transformer's input norm;
  * GEGLU uses the tanh GELU (flax's ``nn.gelu`` default);
  * the compute dtype is the weights' dtype: inputs are cast to it before
    each linear or convolution, norm statistics are taken in f32.
Activations are NCHW inside (channels-last in memory when the caller's
tensor was); ``SpatialVideoTransformer`` works on [B*T, H*W, C] tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import multi_head_attention
from ...ops.temporal_block import (temporal_attention_fused,
                                   temporal_block_fused)

LN_EPS = 1e-6          # flax LayerNorm default
GN_EPS = 1e-5          # openaimodel GroupNorm32
GN_EPS_ATTN = 1e-6     # attention.py Normalize


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings (util.py:141-168): [N] -> [N, dim] f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def linear(x: torch.Tensor, mod: nn.Linear) -> torch.Tensor:
    w = mod.weight
    return F.linear(x.to(w.dtype), w, mod.bias)


def conv(x: torch.Tensor, mod: nn.Module) -> torch.Tensor:
    w = mod.weight
    return mod._conv_forward(x.to(w.dtype), w, mod.bias)


def group_norm(x: torch.Tensor, mod: nn.GroupNorm, eps: float
               ) -> torch.Tensor:
    w = mod.weight
    return F.group_norm(x.to(w.dtype), mod.num_groups, w, mod.bias, eps)


def layer_norm(x: torch.Tensor, mod: nn.LayerNorm,
               eps: float = LN_EPS) -> torch.Tensor:
    w = mod.weight
    return F.layer_norm(x.to(w.dtype), w.shape, w, mod.bias, eps)


def zero_(mod: nn.Module) -> nn.Module:
    for p in mod.parameters():
        nn.init.zeros_(p)
    return mod


class MLPEmbed(nn.Sequential):
    """linear -> SiLU -> linear (time_embed / label_emb / time_pos_embed)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, hidden), nn.SiLU(),
                         nn.Linear(hidden, out_dim))

    def forward(self, x):
        return linear(F.silu(linear(x, self[0])), self[2])


MERGE_STRATEGIES = ("learned_with_images", "fixed")


class AlphaBlender(nn.Module):
    """Spatial/temporal mix a x_spatial + (1 - a) x_temporal
    (util.py:277-318): a = sigmoid(mix_factor), learned, or under
    ``merge_strategy="fixed"`` the constant ``alpha`` (no parameter)."""

    def __init__(self, alpha: float = 0.5,
                 merge_strategy: str = "learned_with_images"):
        super().__init__()
        if merge_strategy not in MERGE_STRATEGIES:
            raise ValueError(f"merge_strategy {merge_strategy!r}: one of "
                             f"{MERGE_STRATEGIES}")
        self.alpha = float(alpha)
        self.fixed = merge_strategy == "fixed"
        if not self.fixed:
            self.mix_factor = nn.Parameter(torch.full((1,), self.alpha))

    def coefficient(self) -> torch.Tensor | float:
        """a in f32: a 0-d tensor on the parameter's device, or under the
        fixed strategy the f32 constant as a Python float (no tensor, so
        no device)."""
        if self.fixed:
            return float(torch.tensor(self.alpha, dtype=torch.float32))
        return torch.sigmoid(self.mix_factor.float())[0]

    def forward(self, x_spatial, x_temporal):
        if self.fixed:
            a = torch.tensor(self.alpha, dtype=x_spatial.dtype)
        else:
            a = torch.sigmoid(self.mix_factor)[0].to(x_spatial.dtype)
        return a * x_spatial + (1.0 - a) * x_temporal


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + time embedding, GN -> SiLU -> conv (zero-init),
    + skip (openaimodel.py:146-284). dims 3: [B, C, T, H, W] input, a
    [B, T, emb] embedding and a (3, 1, 1) kernel."""

    def __init__(self, ch: int, emb_ch: int, out_ch: int | None = None,
                 dims: int = 2, kernel_size=3):
        super().__init__()
        out_ch = out_ch or ch
        self.dims = dims
        Conv = nn.Conv2d if dims == 2 else nn.Conv3d
        ks = (kernel_size,) * dims if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        pad = tuple(k // 2 for k in ks)
        self.in_layers = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                       Conv(ch, out_ch, ks, padding=pad))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, out_ch))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(32, out_ch), nn.SiLU(), nn.Dropout(0.0),
            zero_(Conv(out_ch, out_ch, ks, padding=pad)))
        self.skip_connection = Conv(ch, out_ch, 1) if out_ch != ch else None

    def forward(self, x, emb):
        h = F.silu(group_norm(x, self.in_layers[0], GN_EPS))
        h = conv(h, self.in_layers[2])
        e = linear(F.silu(emb), self.emb_layers[1])
        if self.dims == 3:
            e = e.movedim(-1, 1)               # [B, T, C] -> [B, C, T]
        while e.dim() < h.dim():
            e = e[..., None]
        h = F.silu(group_norm(h + e, self.out_layers[0], GN_EPS))
        h = conv(h, self.out_layers[3])
        skip = x if self.skip_connection is None \
            else conv(x, self.skip_connection)
        return skip + h


class VideoResBlock(ResBlock):
    """2D ResBlock + 3D temporal ResBlock mixed by an AlphaBlender
    (video_model.py:14-80). x: [B*T, C, H, W]."""

    def __init__(self, ch: int, emb_ch: int, out_ch: int | None = None,
                 video_kernel_size=(3, 1, 1), merge_factor: float = 0.5,
                 merge_strategy: str = "learned_with_images"):
        super().__init__(ch, emb_ch, out_ch, dims=2)
        out_ch = out_ch or ch
        self.time_stack = ResBlock(out_ch, emb_ch, out_ch, dims=3,
                                   kernel_size=tuple(video_kernel_size))
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy)

    def forward(self, x, emb, num_frames: int):
        x = super().forward(x, emb)
        bt, c, hh, ww = x.shape
        b = bt // num_frames
        x5 = x.reshape(b, num_frames, c, hh, ww).transpose(1, 2)
        h = self.time_stack(x5, emb.reshape(b, num_frames, -1))
        out = self.time_mixer(x5, h)
        return out.transpose(1, 2).reshape(bt, c, hh, ww)


class Downsample(nn.Module):
    """Stride-2 3x3 convolution (openaimodel.py Downsample)."""

    def __init__(self, ch: int, out_ch: int | None = None):
        super().__init__()
        self.op = nn.Conv2d(ch, out_ch or ch, 3, stride=2, padding=1)

    def forward(self, x):
        return conv(x, self.op)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsampling of the last two dims."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """Nearest 2x + 3x3 convolution (openaimodel.py Upsample)."""

    def __init__(self, ch: int, out_ch: int | None = None):
        super().__init__()
        self.conv = nn.Conv2d(ch, out_ch or ch, 3, padding=1)

    def forward(self, x):
        return conv(upsample_nearest(x), self.conv)


class CrossAttention(nn.Module):
    """Multi-head (self/cross) attention (attention.py:326-421), with the
    optional rank-16 LoRA adapters (attention.py:294-316: down N(0, 1/r),
    up zero). A length-1 context takes the exact shortcut of the JAX package:
    softmax over one key is 1, so the output is to_out(to_v(ctx)) for every
    query."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, add_lora: bool = False,
                 lora_rank: int = 16, lora_scale: float = 1.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        ctx = context_dim or dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        out_dim = dim if context_dim is None else inner
        self.to_out = nn.Sequential(nn.Linear(inner, out_dim), nn.Dropout(0.0))
        self.add_lora = add_lora
        self.lora_scale = lora_scale
        if add_lora:
            for name, i, o in (("q", dim, inner), ("k", ctx, inner),
                               ("v", ctx, inner), ("out", inner, out_dim)):
                down = nn.Linear(i, lora_rank, bias=False)
                nn.init.normal_(down.weight, std=1.0 / lora_rank)
                setattr(self, f"{name}_adapter_down", down)
                setattr(self, f"{name}_adapter_up",
                        zero_(nn.Linear(lora_rank, o, bias=False)))

    def _proj(self, name: str, base: nn.Linear, t):
        out = linear(t, base)
        if self.add_lora:
            out = out + self.lora_scale * linear(
                linear(t, getattr(self, f"{name}_adapter_down")),
                getattr(self, f"{name}_adapter_up"))
        return out

    def forward(self, x, context=None):
        ctx = x if context is None else context
        if context is not None and context.shape[1] == 1:
            v = self._proj("v", self.to_v, ctx)
            out = self._proj("out", self.to_out[0], v)        # [B, 1, C]
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        q = self._proj("q", self.to_q, x)
        k = self._proj("k", self.to_k, ctx)
        v = self._proj("v", self.to_v, ctx)
        B, S, inner = q.shape
        heads, dh = self.heads, self.dim_head
        out = multi_head_attention(q.reshape(B, S, heads, dh),
                                   k.reshape(B, k.shape[1], heads, dh),
                                   v.reshape(B, v.shape[1], heads, dh))
        return self._proj("out", self.to_out[0], out.reshape(B, S, inner))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        a, b = linear(x, self.proj).chunk(2, dim=-1)
        return a * F.gelu(b, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult 4 (attention.py FeedForward)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return linear(self.net[0](x), self.net[2])


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention, cross-attention and feed-forward
    (attention.py:424-524); ``ff_in`` adds the temporal block's extra
    feed-forward in front (extra_ff_mix_layer)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, ff_in: bool = False,
                 add_lora: bool = False):
        super().__init__()
        if ff_in:
            self.norm_in = nn.LayerNorm(dim)
            self.ff_in = FeedForward(dim)
        self.has_ff_in = ff_in
        self.attn1 = CrossAttention(dim, heads, dim_head, add_lora=add_lora)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim,
                                    add_lora=add_lora)
        self.ff = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context=None):
        if self.has_ff_in:
            x = self.ff_in(layer_norm(x, self.norm_in)) + x
        x = self.attn1(layer_norm(x, self.norm1)) + x
        x = self.attn2(layer_norm(x, self.norm2), context) + x
        return self.ff(layer_norm(x, self.norm3)) + x


class VideoTransformerBlock(BasicTransformerBlock):
    """Temporal transformer over the frame axis: (b t) s c -> (b s) t c
    (video_attention.py:111-141), with ff_in."""

    def __init__(self, dim, heads, dim_head, context_dim=None,
                 add_lora=False):
        super().__init__(dim, heads, dim_head, context_dim, ff_in=True,
                         add_lora=add_lora)

    def forward(self, x, context=None, num_frames: int = 1):
        BT, S, C = x.shape
        b = BT // num_frames
        x = x.reshape(b, num_frames, S, C).transpose(1, 2).reshape(
            b * S, num_frames, C)
        if context is not None and context.shape[0] != x.shape[0]:
            # per-(b t) context: frame 0's, repeated per token
            ctx = context.reshape(b, num_frames, *context.shape[1:])[:, 0]
            context = ctx.repeat_interleave(S, dim=0)
        x = super().forward(x, context)
        return x.reshape(b, S, num_frames, C).transpose(1, 2).reshape(
            BT, S, C)


class SpatialVideoTransformer(nn.Module):
    """Spatial transformer + temporal blocks + frame-index embedding +
    AlphaBlender (video_attention.py:239-296). x: [B*T, C, H, W].

    ``fused_temporal``: in bf16, with a length-1 context and S % 16 == 0,
    the temporal stage runs in ``ops.temporal_block``: kernel E (the whole
    stage) at C <= 384, kernel F (its attention) at 384 < C <= 1280 with the
    feed-forwards in plain torch around it (the JAX package's
    ``_fused_ok`` / ``_fused_ok_large`` gates, ``layers.py:467-562``)."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: int | None = None,
                 use_spatial_context: bool = True,
                 merge_factor: float = 0.5,
                 max_time_embed_period: int = 10000,
                 add_lora: bool = False, fused_temporal: bool = False,
                 merge_strategy: str = "learned_with_images"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.use_spatial_context = use_spatial_context
        self.max_time_embed_period = max_time_embed_period
        self.add_lora = add_lora
        self.fused_temporal = fused_temporal
        self.norm = nn.GroupNorm(32, ch, eps=GN_EPS_ATTN)
        self.proj_in = nn.Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim,
                                  add_lora=add_lora) for _ in range(depth)])
        self.time_stack = nn.ModuleList([
            VideoTransformerBlock(inner, heads, dim_head, context_dim,
                                  add_lora=add_lora) for _ in range(depth)])
        self.time_pos_embed = MLPEmbed(ch, ch * 4, ch)
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy)
        self.proj_out = zero_(nn.Linear(inner, ch))

    def _fused_common(self, num_frames, S, time_context) -> bool:
        return (self.fused_temporal and not self.add_lora
                and self.proj_in.weight.dtype == torch.bfloat16
                and num_frames > 1 and time_context is not None
                and time_context.shape[1] == 1 and S % 16 == 0)

    def _alpha_and_bias(self, blk, h, time_context, num_frames):
        """AlphaBlender coefficient (f32; the constant merge factor under
        the fixed strategy) and the length-1 cross-attention output of each
        video, [B, C] bf16 (``layers.py:487-507``)."""
        alpha = self.time_mixer.coefficient()
        b = h.shape[0] // num_frames
        if time_context.shape[0] == b:
            ctx = time_context[:, 0]
        else:
            ctx = time_context.reshape(b, num_frames,
                                       *time_context.shape[1:])[:, 0, 0]
        bf = torch.bfloat16
        a2 = blk.attn2
        bias = ctx.to(bf) @ a2.to_v.weight.to(bf).t()
        out = a2.to_out[0]
        return alpha, bias @ out.weight.to(bf).t() + out.bias.to(bf)

    def _fused_stage(self, blk, h, time_context, num_frames, emb_flat):
        alpha, bias = self._alpha_and_bias(blk, h, time_context, num_frames)
        a1 = blk.attn1
        wqkv = torch.cat([a1.to_q.weight, a1.to_k.weight, a1.to_v.weight])
        return temporal_block_fused(
            h, emb_flat, alpha, bias, blk.norm_in.weight, blk.norm_in.bias,
            blk.ff_in.net[0].proj.weight, blk.ff_in.net[0].proj.bias,
            blk.ff_in.net[2].weight, blk.ff_in.net[2].bias,
            blk.norm1.weight, blk.norm1.bias, wqkv, a1.to_out[0].weight,
            a1.to_out[0].bias, blk.norm3.weight, blk.norm3.bias,
            blk.ff.net[0].proj.weight, blk.ff.net[0].proj.bias,
            blk.ff.net[2].weight, blk.ff.net[2].bias,
            num_frames=num_frames, heads=self.heads,
            dim_head=self.dim_head)

    def _fused_stage_large(self, blk, h, time_context, num_frames, emb):
        alpha, bias = self._alpha_and_bias(blk, h, time_context, num_frames)
        a1 = blk.attn1
        wqkv = torch.cat([a1.to_q.weight, a1.to_k.weight, a1.to_v.weight])
        x = h + emb
        x = blk.ff_in(layer_norm(x, blk.norm_in)) + x
        x = temporal_attention_fused(
            x, bias, blk.norm1.weight, blk.norm1.bias, wqkv,
            a1.to_out[0].weight, a1.to_out[0].bias, num_frames=num_frames,
            heads=self.heads, dim_head=self.dim_head)
        x = blk.ff(layer_norm(x, blk.norm3)) + x
        return (alpha * h.float() + (1.0 - alpha) * x.float()).to(h.dtype)

    def forward(self, x, context=None, num_frames: int = 1):
        BT, C, H, W = x.shape
        x_in = x
        time_context = context if (self.use_spatial_context
                                   and context is not None) else None
        h = group_norm(x, self.norm, GN_EPS_ATTN)
        h = linear(h.permute(0, 2, 3, 1).reshape(BT, H * W, C), self.proj_in)
        frames = torch.arange(num_frames, dtype=torch.float32,
                              device=x.device).repeat(BT // num_frames)
        emb_flat = self.time_pos_embed(
            timestep_embedding(frames, C, self.max_time_embed_period))
        emb = emb_flat[:, None]
        inner = self.heads * self.dim_head
        fused = self._fused_common(num_frames, H * W, time_context)
        for block, tblock in zip(self.transformer_blocks, self.time_stack):
            h = block(h, context)
            if fused and inner <= 384:
                h = self._fused_stage(tblock, h, time_context, num_frames,
                                      emb_flat)
            elif fused and inner <= 1280:
                h = self._fused_stage_large(tblock, h, time_context,
                                            num_frames, emb)
            else:
                h_mix = tblock(h + emb, time_context, num_frames)
                h = self.time_mixer(h, h_mix)
        h = linear(h, self.proj_out)
        return h.reshape(BT, H, W, C).permute(0, 3, 1, 2) + x_in

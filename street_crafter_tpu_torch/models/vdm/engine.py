"""Video diffusion engine (port of ``street_crafter_tpu/models/vdm/
engine.py``): UNet + VAE + CLIP + conditioner + denoiser + sampler.

- ``training_denoise_fn``: the fine-tune's denoiser D(x) of a batch of
  clips, with gradients into the UNet;
- ``sample``: LiDAR-conditioned sampling of one window with CFG (batch
  doubling, or two passes under ``cfg_sequential``), cond-frame
  replacement, and optionally the SDS partial denoise from renders;
- ``encode_images`` / ``decode_latents`` and their chunked forms (the
  decode blends overlapping temporal chunks);
- ``low_vram``: the VAE and CLIP wait on the host while the denoise loop
  runs and come back for the decode, also when the loop raises.

Sequence parallelism (``frames``, a ``parallel.sequence.FramesShard``):
``sample`` and ``training_denoise_fn`` run the UNet on this rank's T/f
frames of the clip; ``sample`` returns the whole clip on every rank
(``parallel/sample.py``).

The f32 engine (compute dtype float32, or null) runs its UNet, VAE and
CLIP calls with TF32 off (``numerics``): cuDNN convolutions in TF32, which
PyTorch allows by default, keep about three digits. The setting is scoped
to those calls (and to the fine-tune's backward, which the trainer runs
under it); the rest of the process keeps its own.

Unlike the JAX engine the modules hold their weights (``engine.unet``,
``engine.vae``, ``engine.clip``); they are built on the meta device and
materialised on ``device`` in the compute dtype by ``materialize``, then
filled by ``weights.load_vdm_params`` (a checkpoint or the seeded random
init). Images and latents are channels-last at every public call.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from ...parallel.sequence import FramesShard
from . import diffusion as D
from .clip import CLIPVisual, CLIPVisualConfig, clip_preprocess
from .conditioner import Conditioning, get_conditioning
from .samplers import euler_edm_sample, euler_edm_sample_sds
from .unet import UNetConfig, VideoUNet
from .vae import VAE, VAEConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    clip: CLIPVisualConfig = CLIPVisualConfig()
    num_frames: int = 25
    num_steps: int = 50
    cfg_scale: float = 2.5
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    fps_id: float = 10.0
    motion_bucket_id: float = 127.0
    cond_aug: float = 0.0
    decode_chunk: int = 0      # > 0: chunked VAE decode, 3-frame overlap
    low_vram: bool = False     # VAE and CLIP on the host during the loop
    cfg_sequential: bool = False   # CFG as two T-frame UNet evals
    encode_chunk: int = 0      # > 0: encoder chunk (else decode_chunk)

    @staticmethod
    def tiny(num_frames: int = 3, num_steps: int = 4) -> "EngineConfig":
        return EngineConfig(unet=UNetConfig.tiny(), vae=VAEConfig.tiny(),
                            clip=CLIPVisualConfig.tiny(),
                            num_frames=num_frames, num_steps=num_steps)


def _dtype(name: Optional[str]) -> torch.dtype:
    return getattr(torch, name) if name else torch.float32


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN convolutions and f32 matmuls while the block
    runs; the settings before it are restored after it."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def materialize(module: torch.nn.Module, device, dtype: torch.dtype,
                trainable: bool = False) -> torch.nn.Module:
    """Allocate a meta-device module's parameters (uninitialised) on
    ``device`` in ``dtype``; the AlphaBlender ``mix_factor`` stays f32, as
    flax keeps its parameters f32 under a bf16 compute dtype. Frozen and
    in eval mode unless ``trainable``."""
    module.to(dtype=dtype)
    for name, p in module.named_parameters():
        if name.endswith("mix_factor"):
            p.data = p.data.float()
    module = module.to_empty(device=device).requires_grad_(trainable)
    return module.train(trainable)


class VideoDiffusionEngine:
    """``training=True`` builds the UNet with gradients on (the fine-tune
    path); the VAE and CLIP stay frozen and run under no_grad either
    way."""

    def __init__(self, cfg: EngineConfig, device="cuda",
                 training: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.device("meta"):
            unet, vae, clip = (VideoUNet(cfg.unet), VAE(cfg.vae),
                               CLIPVisual(cfg.clip))
        self.unet = materialize(unet, self.device, _dtype(cfg.unet.dtype),
                                trainable=training)
        self.vae = materialize(vae, self.device, _dtype(cfg.vae.dtype))
        self.clip = materialize(clip, self.device, _dtype(cfg.clip.dtype))
        self.f32 = all(_dtype(c.dtype) == torch.float32
                       for c in (cfg.unet, cfg.vae, cfg.clip))

    def numerics(self):
        """The context of every UNet, VAE and CLIP call: TF32 off for the
        f32 engine, nothing for a bf16 one."""
        return tf32_off() if self.f32 else contextlib.nullcontext()

    def modules(self) -> dict[str, torch.nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "clip": self.clip}

    # -- first stage ------------------------------------------------------
    @torch.no_grad()
    def encode_images(self, images: torch.Tensor,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
        """[N, H, W, 3] in [-1, 1] -> scaled latents (mode, or a sample
        with ``noise``)."""
        with self.numerics():
            return self.vae.encode(images, noise)

    @torch.no_grad()
    def decode_latents(self, z: torch.Tensor,
                       num_frames: int | None = None) -> torch.Tensor:
        with self.numerics():
            return self.vae.decode(z, num_frames or self.cfg.num_frames)

    @torch.no_grad()
    def decode_latents_chunked(self, z: torch.Tensor, chunk: int = 8,
                               overlap: int = 3,
                               frames: FramesShard | None = None
                               ) -> torch.Tensor:
        """Overlapping temporal chunks, averaged over the overlap
        (decode_first_stage, diffusion_condition.py:183-214); each chunk
        sees ``overlap`` frames of context before its own. The chunks are
        independent: with ``frames`` (``z`` whole on every rank) the frames
        ranks decode every f-th chunk, gather them, and blend as one device
        does."""
        n = z.shape[0]
        if n <= chunk or overlap >= chunk:
            return self.decode_latents(z, num_frames=n)
        step = chunk - overlap
        # chunk i: frames [pos - overlap, pos + step) of z, pos = overlap +
        # i step (its first overlap frames are the last of chunk i - 1)
        spans = [(pos - overlap, min(pos + step, n))
                 for pos in range(overlap, n, step)]
        if frames is None:
            outs = [self.decode_latents(z[a:b], num_frames=b - a)
                    for a, b in spans]
        else:
            outs = self._decode_spread(z, spans, chunk, frames)
        res = outs[0]
        for out in outs[1:]:
            # blend on the accumulated frames: with step < overlap the last
            # piece is shorter than the overlap
            res = torch.cat([res[:-overlap],
                             (res[-overlap:] + out[:overlap]) / 2.0,
                             out[overlap:]])
        return res

    def _decode_spread(self, z, spans, chunk: int, fs: FramesShard
                       ) -> list[torch.Tensor]:
        """The chunks of ``spans`` decoded over the frames ranks (chunk i
        on rank i mod f, padded to ``chunk`` frames), gathered into every
        rank."""
        f = fs.size
        up = 2 ** (len(self.cfg.vae.ch_mult) - 1)
        mine = torch.zeros(
            (-(-len(spans) // f), chunk, z.shape[1] * up, z.shape[2] * up,
             self.cfg.vae.out_ch), dtype=_dtype(self.cfg.vae.dtype),
            device=z.device)
        for k, i in enumerate(range(fs.index, len(spans), f)):
            a, b = spans[i]
            mine[k, :b - a] = self.decode_latents(z[a:b], num_frames=b - a)
        got = fs.mesh.all_gather(mine[None], 0, "frames")
        return [got[i % f, i // f, :b - a] for i, (a, b) in enumerate(spans)]

    @torch.no_grad()
    def encode_images_chunked(self, images: torch.Tensor,
                              chunk: int = 8) -> torch.Tensor:
        """The per-frame encoder needs no temporal context: plain chunks."""
        return torch.cat([self.encode_images(images[i:i + chunk])
                          for i in range(0, images.shape[0], chunk)])

    @torch.no_grad()
    def clip_embed(self, images: torch.Tensor) -> torch.Tensor:
        with self.numerics():
            return self.clip(clip_preprocess(images,
                                             self.cfg.clip.image_size))

    # -- conditioning -------------------------------------------------------
    def build_conditioning(self, cond_frame: torch.Tensor
                           ) -> tuple[Conditioning, Conditioning]:
        """cond_frame: [1, H, W, 3] in [-1, 1] (frame 0 of the window)."""
        c = self.cfg
        return get_conditioning(
            clip_embed_fn=self.clip_embed, vae_encode_fn=self.encode_images,
            cond_frame_without_noise=cond_frame, cond_frame=cond_frame,
            num_frames=c.num_frames, fps_id=c.fps_id,
            motion_bucket_id=c.motion_bucket_id, cond_aug=c.cond_aug,
            vector_outdim=c.unet.adm_in_channels // 3)

    # -- denoising ----------------------------------------------------------
    def make_cfg_denoise_fn(self, cond: Conditioning, uc: Conditioning,
                            guidance_latents: torch.Tensor | None,
                            cond_mask: torch.Tensor,
                            cfg_scale: float | None = None,
                            frames: FramesShard | None = None) -> Callable:
        """CFG denoiser (guiders.py:28-41 + wrappers.py:25-41): the
        conditioned half gets guidance scale 1, the unconditioned half 0.
        ``cfg_sequential`` runs the halves as two T-frame UNet evaluations
        (the same math, half the activations). With ``frames`` every
        per-frame input holds this rank's frames."""
        T = self.cfg.num_frames if frames is None else frames.local
        scale = self.cfg.cfg_scale if cfg_scale is None else cfg_scale
        g = guidance_latents

        @torch.no_grad()
        def run_unet(x, c_noise, concat, crossattn, vector, cm, gs):
            with self.numerics():
                return self.unet(torch.cat([x, concat.to(x.dtype)], dim=-1),
                                 c_noise, crossattn, vector, num_frames=T,
                                 cond_mask=cm, guidance_input=gs[0],
                                 guidance_scale=gs[1], frames=frames)

        def half_fn(c: Conditioning, gscale: float):
            gs = (None, None) if g is None else \
                (g, torch.full((T,), gscale, device=g.device))
            return lambda x, c_noise: run_unet(
                x, c_noise, c.concat, c.crossattn, c.vector, cond_mask, gs)

        if self.cfg.cfg_sequential:
            def denoise_fn(x, sigma):
                uncond = D.denoise(half_fn(uc, 0.0), x, sigma)
                cond_out = D.denoise(half_fn(cond, 1.0), x, sigma)
                return D.vanilla_cfg(uncond, cond_out, scale)
            return denoise_fn

        concat2 = torch.cat([uc.concat, cond.concat])
        ctx2 = torch.cat([uc.crossattn, cond.crossattn])
        vec2 = torch.cat([uc.vector, cond.vector])
        cm2 = torch.cat([cond_mask, cond_mask])
        if g is not None:
            gs2 = (torch.cat([g, g]),
                   torch.cat([torch.zeros(T, device=g.device),
                              torch.ones(T, device=g.device)]))
        else:
            gs2 = (None, None)

        def denoise_fn(x, sigma):
            den = D.denoise(
                lambda sx, c_noise: run_unet(sx, c_noise, concat2, ctx2,
                                             vec2, cm2, gs2),
                torch.cat([x, x]), torch.cat([sigma, sigma]))
            uncond, cond_out = den.chunk(2)
            return D.vanilla_cfg(uncond, cond_out, scale)

        return denoise_fn

    # -- training -----------------------------------------------------------
    def training_denoise_fn(self, cond: Conditioning,
                            guidance_latents: torch.Tensor | None,
                            guidance_scale: torch.Tensor | None,
                            frames: FramesShard | None = None
                            ) -> Callable:
        """(noised, sigma, cond_mask) -> D(x) for ``loss.diffusion_loss``
        over B whole clips: cond leaves and guidance [B*T, ...], guidance
        scale [B*T] (``engine.py:341-357``, its clip map written out as a
        batch); with ``frames``, T is this rank's T/f frames of each
        clip."""
        T = self.cfg.num_frames if frames is None else frames.local

        def fn(noised, sigma, cond_mask):
            def model_fn(scaled_x, c_noise):
                net_in = torch.cat([scaled_x, cond.concat.to(scaled_x.dtype)],
                                   dim=-1)
                with self.numerics():
                    return self.unet(net_in, c_noise, cond.crossattn,
                                     cond.vector, num_frames=T,
                                     cond_mask=cond_mask,
                                     guidance_input=guidance_latents,
                                     guidance_scale=guidance_scale,
                                     frames=frames)
            return D.denoise(model_fn, noised, sigma)

        return fn

    # -- sampling -----------------------------------------------------------
    @torch.no_grad()
    def sample(self, guide_images: torch.Tensor, cond_image: torch.Tensor,
               noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               render_images: torch.Tensor | None = None,
               sds_scale: float | None = None,
               cfg_scale: float | None = None,
               num_steps: int | None = None,
               cond_indices: tuple[int, ...] = (0,),
               frames: FramesShard | None = None) -> torch.Tensor:
        """Conditioned sampling of one window (sample_condition.py:418-473).
        guide_images [T, H, W, 3] and cond_image [len(cond_indices), H, W,
        3] in [-1, 1]; ``noise`` (standard normal, latent shape) or
        ``generator`` draws the initial noise. Returns [T, H, W, 3] in
        [-1, 1].

        ``frames``: this rank denoises its frames (``frames.frames``) of
        the window. It encodes only those of the guide and render images;
        the conditioning image, its latent and CLIP embedding are computed
        on every rank, as one device does. The cond frames and mask are
        built over the whole T and sliced; the noise is drawn over the
        whole T (so the result does not depend on f) and sliced. The
        latents are gathered, and the chunked decode spreads its chunks
        over the ranks (``decode_chunk`` 0: every rank decodes the
        clip)."""
        c = self.cfg
        T = c.num_frames
        mine = slice(0, T) if frames is None else frames.frames
        steps = num_steps or c.num_steps
        dev = self.device
        enc_chunk = c.encode_chunk or c.decode_chunk

        def encode(images):
            images = images[mine].to(dev)
            if enc_chunk:
                return self.encode_images_chunked(images, enc_chunk)
            return self.encode_images(images)

        guidance_latents = encode(guide_images)
        cond_image = cond_image.to(dev)
        cond, uc = self.build_conditioning(cond_image[:1])
        cond_latent = self.encode_images(cond_image)
        cond_frame = torch.zeros((T,) + tuple(cond_latent.shape[1:]),
                                 device=dev)
        cond_mask = torch.zeros((T,), device=dev)
        for j, idx in enumerate(cond_indices):
            cond_frame[idx] = cond_latent[j].float()
            cond_mask[idx] = 1.0
        if frames is not None:
            cond, uc = (Conditioning(*(x[mine] for x in cc))
                        for cc in (cond, uc))
            cond_frame, cond_mask = cond_frame[mine], cond_mask[mine]
        sigmas = D.edm_sigmas(steps, c.sigma_min, c.sigma_max, c.rho,
                              device=dev)
        if noise is None:
            noise = torch.randn((T,) + tuple(guidance_latents.shape[1:]),
                                generator=generator, device=dev)
        noise = noise[mine].to(dev, torch.float32)
        render_latents = (encode(render_images)
                          if render_images is not None
                          and sds_scale is not None else None)

        offloaded = []
        if c.low_vram:
            for m in (self.vae, self.clip):
                m.to("cpu")
                offloaded.append(m)
        try:
            denoise_fn = self.make_cfg_denoise_fn(
                cond, uc, guidance_latents, cond_mask, cfg_scale, frames)
            if render_latents is not None:
                z = euler_edm_sample_sds(denoise_fn, noise, sigmas,
                                         render_latents, sds_scale,
                                         cond_frame, cond_mask)
            else:
                z = euler_edm_sample(denoise_fn, noise, sigmas, cond_frame,
                                     cond_mask)
        finally:
            for m in offloaded:
                m.to(dev)
        if frames is not None:
            z = frames.mesh.all_gather(z, 0, "frames")
        if c.decode_chunk:
            out = self.decode_latents_chunked(z, chunk=c.decode_chunk,
                                              frames=frames)
        else:
            out = self.decode_latents(z, num_frames=T)
        return out.float().clamp(-1.0, 1.0)

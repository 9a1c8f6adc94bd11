"""Video-diffusion fine-tune step (port of ``street_crafter_tpu/training/
vdm_trainer.py``) on one device.

The reference fine-tunes the UNet only (VAE and CLIP frozen,
diffusion_condition.py:298-355). One step, in the JAX package's order:

- the guidance drop: each clip keeps its LiDAR guidance with probability
  1 - 0.15 (diffusion_condition.py:167-176);
- the loss of the batch of clips (``loss.diffusion_loss``), in
  ``accumulate`` micro-batches over the clip axis, whose f32 gradients are
  summed and divided by their count;
- one global-norm clip over ALL UNet gradients, frozen and slow groups
  included (optax ``clip_by_global_norm`` before ``multi_transform``);
- Adam (b1 0.9, b2 0.999, eps 1e-8, optax's bias correction) per param
  group: "base" at lr, "slow" at lr x scale (its moments still update; at
  scale 0 its params stay bit-identical), "frozen" with no moments and no
  update; the lr times an optional schedule of the group's step count;
- the EMA of the f32 masters at ``ema_decay``.

Weights: the UNet module computes in its dtype (bf16 at full width) while
the trainer keeps f32 master copies, moments and EMA as plain tensors
(``VDMTrainState``); after each update the masters are cast into the
module. A weight used once per forward so gets its gradient as the bf16-
rounded value flax gives an f32 parameter cast per op. ``AlphaBlender``'s
``mix_factor`` stays f32 in the module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.vdm.conditioner import Conditioning
from ..models.vdm.engine import VideoDiffusionEngine
from ..models.vdm.loss import LossDraws, diffusion_loss, draw_loss

B1, B2, EPS = 0.9, 0.999, 1e-8
GROUPS = ("base", "slow")        # the groups with Adam state


def is_temporal_param(name: str) -> bool:
    """The reference's predicate: the torch name contains 'time_stack'
    (diffusion_condition.py:298-320): the VideoResBlocks' temporal stacks,
    the temporal transformer blocks and ``cond_time_stack_embed``. The port
    keeps the torch names, so no other spelling needs matching."""
    return "time_stack" in name


def is_peft_param(name: str) -> bool:
    """train_peft_adapters group: LoRA adapters and cond_time_stack_embed
    (diffusion_condition.py:321-329)."""
    return "adapter" in name or "cond_time_stack_embed" in name


def param_group_labels(names, slow_spatial_layers: bool = False,
                       slow_temporal_layers: bool = False,
                       train_peft_adapters: bool = False) -> dict[str, str]:
    """{name: "base" | "slow" | "frozen"} for UNet parameter names."""
    def label(name):
        if slow_spatial_layers:
            return "base" if is_temporal_param(name) else "slow"
        if slow_temporal_layers:
            return "slow" if is_temporal_param(name) else "base"
        if train_peft_adapters:
            return "base" if is_peft_param(name) else "frozen"
        return "base"
    return {n: label(n) for n in names}


def groups_from_config(v) -> tuple[dict, float]:
    """The ``vdm_train`` node's group flags (waymo_high_res_mix.yaml:12-16)
    -> (flags for ``param_group_labels``, the slow group's lr scale)."""
    flags = {k: bool(v.get(k, False)) for k in (
        "slow_spatial_layers", "slow_temporal_layers",
        "train_peft_adapters")}
    if flags["slow_spatial_layers"]:
        scale = float(v.get("slow_spatial_layers_scale", 0.1))
    else:
        scale = float(v.get("slow_temporal_layers_scale", 0.0))
    return flags, scale


@dataclasses.dataclass
class VDMTrainState:
    """The fine-tune's state: f32 masters, Adam moments of the "base" and
    "slow" groups with each group's step count, the EMA, the step."""
    masters: dict[str, torch.Tensor]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: dict[str, int]
    ema: dict[str, torch.Tensor]
    step: int

    def to_dict(self) -> dict:
        """The fields as a dict of the same tensors (no copies)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @staticmethod
    def from_dict(d: dict, device=None) -> "VDMTrainState":
        def move(t):
            return {k: v.to(device) for k, v in t.items()}
        return VDMTrainState(masters=move(d["masters"]), mu=move(d["mu"]),
                             nu=move(d["nu"]), count=dict(d["count"]),
                             ema=move(d["ema"]), step=int(d["step"]))


class StepDraws(NamedTuple):
    """The random numbers of one step: the per-clip guidance keep [B]
    (1.0 keeps) and the loss draws of the whole batch."""
    keep: torch.Tensor
    loss: LossDraws


class VDMTrainer:
    """The fine-tune step over ``engine``'s UNet. Starts from ``masters``
    (f32 UNet weights, e.g. from ``weights.load_vdm_params``) with zero
    moments and the EMA at the masters, or from a whole ``state`` (a
    checkpoint or a converted JAX state), whose masters are cast into the
    module."""

    def __init__(self, engine: VideoDiffusionEngine,
                 masters: dict[str, torch.Tensor] | None = None,
                 lr: float = 1e-5, grad_clip: float = 0.3,
                 ema_decay: float = 0.9999, guidance_dropout: float = 0.15,
                 accumulate: int = 1, group_flags: dict | None = None,
                 slow_scale: float = 1.0,
                 schedule: Callable[[int], float] | None = None,
                 state: VDMTrainState | None = None):
        self.engine = engine
        self.params = dict(engine.unet.named_parameters())
        if state is not None:
            masters = state.masters
        missing = sorted(set(self.params) - set(masters or {}))
        if missing:
            raise KeyError(f"no master weights for {missing[:5]}")
        # every parameter gets its gradient: the clip's norm counts the
        # frozen group too
        self.labels = param_group_labels(self.params, **(group_flags or {}))
        self.lr, self.grad_clip = lr, grad_clip
        self.ema_decay = ema_decay
        self.guidance_dropout = guidance_dropout
        self.accumulate = int(accumulate)
        self.lr_scale = {"base": 1.0, "slow": slow_scale}
        self.schedule = schedule
        if state is not None:
            # adopt the state (a checkpoint or a converted JAX state) and
            # cast its masters into the module
            self.state = state
            with torch.no_grad():
                for name, p in self.params.items():
                    p.copy_(state.masters[name])
            return
        adam = [n for n, g in self.labels.items() if g in GROUPS]
        self.state = VDMTrainState(
            masters=masters,
            mu={n: torch.zeros_like(masters[n]) for n in adam},
            nu={n: torch.zeros_like(masters[n]) for n in adam},
            count={g: 0 for g in GROUPS if g in self.labels.values()},
            ema={n: m.clone() for n, m in masters.items()}, step=0)

    # -- the step -----------------------------------------------------------
    def draw(self, batch_size: int, latents_shape,
             generator: torch.Generator) -> StepDraws:
        dev = self.engine.device
        keep = (torch.rand((batch_size,), generator=generator, device=dev)
                < 1.0 - self.guidance_dropout).float()
        T = self.engine.cfg.num_frames
        return StepDraws(keep, draw_loss(latents_shape, T, generator, dev))

    def _loss(self, latents, cond: Conditioning, guidance, gscale,
              draws: LossDraws):
        T = self.engine.cfg.num_frames
        dfn = self.engine.training_denoise_fn(cond, guidance, gscale)
        return diffusion_loss(dfn, latents, draws, num_frames=T,
                              offset_noise_level=0.02,
                              use_additional_loss=True)

    def train_step(self, batch: dict, draws: StepDraws | None = None,
                   generator: torch.Generator | None = None
                   ) -> dict[str, float]:
        """``batch``: {"latents": [B, T, h, w, 4], "cond": Conditioning of
        [B, T, ...] leaves, "guidance_latents": [B, T, h, w, 4]}. The draws
        come from ``draws`` or else from ``generator``. Returns the step's
        scalars (means over the clips)."""
        lat = batch["latents"]
        B, T = lat.shape[:2]
        flat = lat.reshape(B * T, *lat.shape[2:])
        if draws is None:
            draws = self.draw(B, flat.shape, generator)
        if B % self.accumulate:
            raise ValueError(f"{B} clips do not split into "
                             f"{self.accumulate} micro-batches")
        m = B // self.accumulate
        gscale = draws.keep.float()[:, None].expand(B, T)
        grads: dict[str, torch.Tensor] = {}
        sums: dict[str, float] = {}
        for i in range(self.accumulate):
            clips = slice(i * m, (i + 1) * m)
            rows = slice(i * m * T, (i + 1) * m * T)

            def frames(x):
                return x[clips].reshape(m * T, *x.shape[2:])

            cond = Conditioning(*(frames(x) for x in batch["cond"]))
            ld = LossDraws(draws.loss.sigma_normal[clips],
                           draws.loss.cond_mask[rows],
                           draws.loss.noise[rows], draws.loss.offset[rows])
            loss, scalars = self._loss(frames(lat), cond,
                                       frames(batch["guidance_latents"]),
                                       gscale[clips].reshape(-1), ld)
            loss.backward()
            for name, p in self.params.items():
                if p.grad is None:
                    g = torch.zeros_like(self.state.masters[name])
                else:
                    g = p.grad.float()
                    p.grad = None
                grads[name] = grads[name] + g if name in grads else g
            for k, v in scalars.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach())
        if self.accumulate > 1:
            for g in grads.values():
                g.div_(self.accumulate)
        self._apply(grads)
        return {k: v / self.accumulate for k, v in sums.items()}

    @torch.no_grad()
    def _apply(self, grads: dict[str, torch.Tensor]) -> None:
        st = self.state
        # one global norm over every gradient (optax clip_by_global_norm)
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if not bool(norm < self.grad_clip):
            for g in grads.values():
                g.div_(norm).mul_(self.grad_clip)
        for group in st.count:
            count = st.count[group]
            lr = self.lr * self.lr_scale[group]
            if self.schedule is not None:
                lr = lr * self.schedule(count)
            st.count[group] = count + 1
            c1 = float(1 - np.float32(B1) ** (count + 1))
            c2 = float(1 - np.float32(B2) ** (count + 1))
            names = [n for n in grads if self.labels[n] == group]
            for part in _pieces(names):
                gs = [grads[n] for n in part]
                mus = [st.mu[n] for n in part]
                nus = [st.nu[n] for n in part]
                torch._foreach_mul_(mus, B1)
                torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - B1))
                torch._foreach_mul_(nus, B2)
                torch._foreach_add_(nus, torch._foreach_mul(
                    torch._foreach_mul(gs, gs), 1 - B2))
                if lr == 0.0:
                    continue        # p + 0 * u == p: bit-identical
                den = torch._foreach_sqrt(torch._foreach_div(nus, c2))
                torch._foreach_add_(den, EPS)
                upd = torch._foreach_div(torch._foreach_div(mus, c1), den)
                torch._foreach_mul_(upd, -lr)
                masters = [st.masters[n] for n in part]
                torch._foreach_add_(masters, upd)
                for n, m in zip(part, masters):
                    self.params[n].copy_(m)
        d = self.ema_decay
        names = list(st.ema)
        for part in _pieces(names):
            emas = [st.ema[n] for n in part]
            torch._foreach_mul_(emas, d)
            torch._foreach_add_(emas, torch._foreach_mul(
                [st.masters[n] for n in part], 1 - d))
        st.step += 1


def _pieces(names: list, n: int = 64):
    """``names`` in runs of ``n``: the optimizer's temporaries stay a
    fraction of the parameters' size."""
    for i in range(0, len(names), n):
        yield names[i:i + n]

"""Video-diffusion fine-tune step (port of ``street_crafter_tpu/training/
vdm_trainer.py``), on one device or over data-parallel ranks.

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

Data parallel (``rules``: ``parallel.sharding.ShardingRules`` over the
ranks' mesh; the JAX step's ``rules=``): each rank takes its clips of the
global batch and its slice of the global ``StepDraws`` (so the result does
not depend on the world size W), runs the micro-batch loop on them, then
the f32 gradients and scalars are all-reduced and divided by the global
micro-batch count. The clip takes the global norm of the whole all-reduced
gradient on every rank. Then, by ``rules``:

- DDP (``zero=False``): every rank updates every leaf;
- ZeRO-2 (the default): the moments of a leaf live only for this rank's
  chunk on ``opt_state_spec``'s dim; each rank updates that chunk of the
  (replicated) masters and ``all_gather`` rebuilds them;
- FSDP (``fsdp_params``): the masters and the EMA are sharded like the
  moments; the new master chunks are cast to the module's dtype and
  gathered into the module, whose compute copy stays whole on each rank
  (as DeepSpeed ZeRO-2 with bf16 params; JAX's FSDP shards the compute
  params too).

Sequence parallelism (a mesh whose ``frames`` axis is f > 1, the JAX step
on a ``{data, frames}`` mesh): each rank holds T/f frames of its clips
(``batch`` leaves [B, T/f, ...]) and takes those frames' rows of the
draws; the UNet exchanges what crosses frames (``parallel/sequence.py``)
and each rank's loss is its part of the clips' loss. The gradients and
scalars are all-reduced over every rank and divided by ``accumulate x
data``: the frames ranks hold parts of one loss, not copies of it. The
optimizer state is sharded over ``data`` and replicated over ``frames``.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used by the
optimizer.
``shard_train_state`` / ``gather_train_state`` split a whole train state
into a rank's shards and back (checkpoints are whole: the one-GPU format).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.vdm.conditioner import Conditioning
from ..models.vdm.engine import VideoDiffusionEngine
from ..models.vdm.loss import LossDraws, diffusion_loss, draw_loss
from ..parallel.sequence import FramesShard, frames_shard
from ..parallel.sharding import ShardingRules

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

    def clips(self, c: slice, num_frames: int) -> "StepDraws":
        """The draws of clips ``c`` (their frames' rows of the loss
        draws)."""
        rows = slice(c.start * num_frames, c.stop * num_frames)
        ld = self.loss
        return StepDraws(self.keep[c], LossDraws(
            ld.sigma_normal[c], ld.cond_mask[rows], ld.noise[rows],
            ld.offset[rows]))

    def frames(self, fs: FramesShard) -> "StepDraws":
        """The rows of ``fs``'s frames of every clip."""
        T, mine = fs.num_frames, fs.frames

        def cut(x):
            x = x.reshape(-1, T, *x.shape[1:])[:, mine]
            return x.reshape(-1, *x.shape[2:])
        ld = self.loss
        return StepDraws(self.keep, LossDraws(
            ld.sigma_normal, cut(ld.cond_mask), cut(ld.noise),
            cut(ld.offset)))


def _state_dims(rules: ShardingRules | None, shapes: dict) -> dict:
    """{field: {name: sharded dim or None}} of a train state's dicts."""
    def dims(spec):
        return {n: (spec(s) if rules is not None else None)
                for n, s in shapes.items()}
    if rules is None:
        return {f: dims(None) for f in ("masters", "mu", "nu", "ema")}
    p, o = dims(rules.param_spec), dims(rules.opt_state_spec)
    return {"masters": p, "ema": p, "mu": o, "nu": o}


def shard_train_state(state: VDMTrainState, rules: ShardingRules
                      ) -> VDMTrainState:
    """This rank's shards of a whole train state: the moments on
    ``opt_state_spec``'s dim, the masters and the EMA on ``param_spec``'s
    (contiguous copies; replicated leaves are shared, not copied)."""
    dims = _state_dims(rules, {n: m.shape for n, m in state.masters.items()})

    def cut(field):
        return {n: (x if dims[field][n] is None else
                    rules.shard(x, dims[field][n]).clone(
                        memory_format=torch.contiguous_format))
                for n, x in getattr(state, field).items()}
    return VDMTrainState(masters=cut("masters"), mu=cut("mu"), nu=cut("nu"),
                         count=dict(state.count), ema=cut("ema"),
                         step=state.step)


def gather_train_state(state: VDMTrainState, rules: ShardingRules,
                       shapes: dict, device="cpu") -> VDMTrainState:
    """The whole train state from every rank's shards (a collective: every
    rank calls it), on ``device``, leaf by leaf. ``shapes``: the whole
    leaves' shapes by name."""
    dims = _state_dims(rules, shapes)

    def join(field):
        return {n: rules.unshard(x, dims[field][n]).to(device)
                for n, x in getattr(state, field).items()}
    return VDMTrainState(masters=join("masters"), mu=join("mu"),
                         nu=join("nu"), count=dict(state.count),
                         ema=join("ema"), step=state.step)


class VDMTrainer:
    """The fine-tune step over ``engine``'s UNet. Starts from ``masters``
    (f32 UNet weights, e.g. from ``weights.load_vdm_params``) with zero
    moments and the EMA at the masters, or from a whole ``state`` (a
    checkpoint or a converted JAX state), whose masters are cast into the
    module. With ``rules`` the trainer keeps this rank's shards
    (``self.state``; ``whole_state()`` gathers them)."""

    def __init__(self, engine: VideoDiffusionEngine,
                 masters: dict[str, torch.Tensor] | None = None,
                 lr: float = 1e-5, grad_clip: float = 0.3,
                 ema_decay: float = 0.9999, guidance_dropout: float = 0.15,
                 accumulate: int = 1, group_flags: dict | None = None,
                 slow_scale: float = 1.0,
                 schedule: Callable[[int], float] | None = None,
                 state: VDMTrainState | None = None,
                 rules: ShardingRules | None = None):
        self.engine = engine
        self.params = dict(engine.unet.named_parameters())
        self.rules = rules
        self.mesh = rules.mesh if rules is not None else None
        # clips are split over data; frames ranks hold parts of each clip
        self.data = self.mesh.size("data") if self.mesh is not None else 1
        self.frames = frames_shard(self.mesh, engine.cfg.num_frames)
        # seconds of the last step's gradient all-reduce and master gathers
        self.comm_s = {"all_reduce": 0.0, "all_gather": 0.0}
        self._dims = _state_dims(rules, {n: p.shape for n, p in
                                         self.params.items()})
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
            with torch.no_grad():
                for name, p in self.params.items():
                    p.copy_(state.masters[name])
            self.state = (state if rules is None
                          else shard_train_state(state, rules))
            return
        adam = [n for n, g in self.labels.items() if g in GROUPS]
        masters = {n: self._own(m, "masters", n) for n, m in masters.items()}

        def zeros(n):
            return torch.zeros(self._local(self.params[n], "mu", n).shape,
                               dtype=torch.float32,
                               device=self.params[n].device)
        self.state = VDMTrainState(
            masters=masters, mu={n: zeros(n) for n in adam},
            nu={n: zeros(n) for n in adam},
            count={g: 0 for g in GROUPS if g in self.labels.values()},
            ema={n: m.clone() for n, m in masters.items()}, step=0)

    def whole_state(self, device="cpu") -> VDMTrainState:
        """The whole train state (gathered from the ranks' shards: every
        rank calls it), for a checkpoint."""
        if self.rules is None:
            return self.state
        return gather_train_state(self.state, self.rules,
                                  {n: p.shape for n, p in
                                   self.params.items()}, device)

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
        fs = self.frames
        T = self.engine.cfg.num_frames if fs is None else fs.local
        dfn = self.engine.training_denoise_fn(cond, guidance, gscale, fs)
        return diffusion_loss(dfn, latents, draws, num_frames=T,
                              offset_noise_level=0.02,
                              use_additional_loss=True, frames=fs)

    def train_step(self, batch: dict, draws: StepDraws | None = None,
                   generator: torch.Generator | None = None
                   ) -> dict[str, float]:
        """``batch``: this rank's clips, {"latents": [B, T, h, w, 4], "cond":
        Conditioning of [B, T, ...] leaves, "guidance_latents": [B, T, h, w,
        4]}, T this rank's frames of each clip (the clip's T / f). The
        draws of the global batch (B x the data size clips of the clip's
        T) come from ``draws`` or else from ``generator``. Returns the
        step's scalars (means over the global batch's clips)."""
        lat = batch["latents"]
        B, T = lat.shape[:2]
        Tc = self.engine.cfg.num_frames
        if T != (Tc if self.frames is None else self.frames.local):
            f = 1 if self.frames is None else self.frames.size
            raise ValueError(f"{T} frames a clip in the batch of a "
                             f"{Tc}-frame clip over {f} frames ranks")
        Bg = B * self.data
        if draws is None:
            draws = self.draw(Bg, (Bg * Tc, *lat.shape[2:]), generator)
        if draws.keep.shape[0] != Bg:
            raise ValueError(f"draws of {draws.keep.shape[0]} clips for a "
                             f"global batch of {Bg}")
        if self.mesh is not None:
            draws = draws.clips(self.mesh.local_slice(Bg, "data"), Tc)
        if self.frames is not None:
            draws = draws.frames(self.frames)
        if B % self.accumulate:
            raise ValueError(f"{B} clips do not split into "
                             f"{self.accumulate} micro-batches")
        m = B // self.accumulate
        gscale = draws.keep.float()[:, None].expand(B, T)
        grads: dict[str, torch.Tensor] = {}
        sums: dict[str, torch.Tensor] = {}
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
            with self.engine.numerics():
                loss.backward()
            for name, p in self.params.items():
                if p.grad is None:
                    g = torch.zeros_like(p, dtype=torch.float32)
                else:
                    g = p.grad.float()
                    p.grad = None
                grads[name] = grads[name] + g if name in grads else g
            for k, v in scalars.items():
                v = v.detach().float()
                sums[k] = sums[k] + v if k in sums else v
        names = sorted(sums)
        totals = torch.stack([sums[k] for k in names])
        if self.mesh is not None:
            self.comm_s["all_reduce"] = self._timed(
                self.mesh.all_reduce_, list(grads.values()) + [totals])
        n = self.accumulate * self.data
        if n > 1:
            for g in grads.values():
                g.div_(n)
        self._apply(grads)
        return {k: float(v) / n for k, v in zip(names, totals)}

    def _timed(self, fn, *args) -> float:
        """Seconds of ``fn(*args)`` between two synchronisations of the
        engine's device."""
        sync = (torch.cuda.synchronize if self.engine.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        return time.perf_counter() - t0

    def _local(self, x: torch.Tensor, field: str, name: str) -> torch.Tensor:
        """This rank's chunk of a whole leaf ``x`` in ``field``'s layout (a
        view)."""
        d = self._dims[field][name]
        return x if d is None else self.rules.shard(x, d)

    def _own(self, x: torch.Tensor, field: str, name: str) -> torch.Tensor:
        """``_local`` as a contiguous copy when it is a chunk."""
        d = self._dims[field][name]
        return x if d is None else self.rules.shard(x, d).clone(
            memory_format=torch.contiguous_format)

    def _publish(self, name: str, updated: torch.Tensor) -> None:
        """The module's weight (and, under ZeRO-2, the whole master) from
        this rank's ``updated`` master chunk."""
        p = self.params[name]
        dp, dm = self._dims["masters"][name], self._dims["mu"][name]
        if dp is not None:          # FSDP: gather the cast chunks
            p.copy_(self.rules.unshard(updated.to(p.dtype), dp))
        elif dm is not None:        # ZeRO-2: rebuild the whole master
            whole = self.rules.unshard(updated.contiguous(), dm)
            self.state.masters[name].copy_(whole)
            p.copy_(whole)
        else:
            p.copy_(updated)

    @torch.no_grad()
    def _apply(self, grads: dict[str, torch.Tensor]) -> None:
        st = self.state
        self.comm_s["all_gather"] = 0.0
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
                gs = [self._local(grads[n], "mu", n) for n in part]
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
                # the masters' chunk that this rank's moments cover
                masters = [st.masters[n] if self._dims["masters"][n]
                           is not None else self._local(st.masters[n], "mu",
                                                        n) for n in part]
                torch._foreach_add_(masters, upd)
                t0 = time.perf_counter()
                for n, m in zip(part, masters):
                    self._publish(n, m)
                self.comm_s["all_gather"] += time.perf_counter() - t0
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

"""Per-rank functions of the port's sequence-parallel tests (run by
``street_crafter_tpu_torch.parallel.mesh.run_ranks`` in spawned gloo
processes). Each takes the rank's ``Mesh`` (``{"data": world}``) first,
builds the mesh of the layout it is given, and returns picklable results.
This module imports no JAX, so the children start without it."""

import numpy as np
import torch


def _mesh(spec: dict):
    from street_crafter_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(spec, device="cpu")


def _np(t):
    return None if t is None else t.detach().cpu().numpy().copy()


# -- the mesh ---------------------------------------------------------------

def mesh_layouts(mesh, specs: list, T: int) -> list:
    """For each spec: the coordinates, the axis ranks and groups, the
    collectives over each axis, an uneven all-to-all over frames and back,
    and ``halo(x, 1)`` of this rank's frames of arange(T) + 100 x its data
    index."""
    out = []
    for spec in specs:
        m = _mesh(spec)
        r = float(m.rank)
        res = {"shape": dict(m.shape), "rank": m.rank,
               "coords": {a: m.coord(a) for a in m.shape},
               "ranks": {a: m.axis_ranks(a) for a in m.shape},
               "groups": sorted(m.groups)}
        for axis in ("data", "frames"):
            s = torch.tensor([r])
            m.all_reduce_([s], axis=axis)
            mx = torch.tensor([r])
            m.all_reduce_([mx], op="max", axis=axis)
            b = torch.tensor([r])
            m.broadcast_([b], src=1, axis=axis)
            g = m.all_gather(torch.tensor([[r]]), 1, axis)
            res[axis] = {"sum": float(s), "max": float(mx),
                         "bcast": float(b), "gather": g.numpy()[0].tolist()}
        n, i = m.size("frames"), m.coord("frames")
        sends = [torch.full(((i + 1) * (j + 2),), 100.0 * m.rank + j)
                 for j in range(n)]
        got = m.all_to_all(sends, [((k + 1) * (i + 2),) for k in range(n)],
                           "frames")
        back = m.all_to_all(got, [tuple(t.shape) for t in sends], "frames")
        res["a2a"] = [t.numpy() for t in got]
        res["a2a_back"] = all(torch.equal(a, b) for a, b in zip(back, sends))
        x = (torch.arange(T, dtype=torch.float32)
             + 100 * m.coord("data"))[m.local_slice(T, "frames")]
        res["halo"] = m.halo(x[:, None], 1, 0, "frames")[:, 0].numpy()
        res["frames_slice"] = m.local_slice(T, "frames")
        out.append(res)
    return out


def exchanges(mesh, spec: dict, X: np.ndarray, R: dict) -> dict:
    """The differentiable exchanges on this rank's frames of X [B, T, S,
    C]: each output and the gradient of sum(output * R[name]'s part) with
    respect to the input."""
    from street_crafter_tpu_torch.parallel import sequence as SQ
    m = _mesh(spec)
    B, T, S, C = X.shape
    fs = SQ.FramesShard(m, T)
    runs = SQ.token_runs(S, fs.size)
    run = slice(sum(runs[:fs.index]), sum(runs[:fs.index + 1]))
    mine = fs.frames
    res = {"runs": runs}

    def leaf(a):
        return torch.tensor(np.ascontiguousarray(a)).requires_grad_(True)

    x = leaf(X[:, mine].reshape(B * fs.local, S, C))
    y = SQ.frames_to_tokens(x, fs, runs)
    (y * torch.tensor(R["to_tokens"][:, :, run]).reshape(y.shape)
     ).sum().backward()
    res["to_tokens"] = (_np(y), _np(x.grad))
    yt = leaf(X[:, :, run].reshape(B * T, -1, C))
    xf = SQ.tokens_to_frames(yt, fs, runs)
    (xf * torch.tensor(R["to_frames"][:, mine]).reshape(xf.shape)
     ).sum().backward()
    res["to_frames"] = (_np(xf), _np(yt.grad))
    x = leaf(X[:, mine])
    h = SQ.frames_halo(x, 1, 1, fs)
    win = slice(fs.start, fs.start + fs.local + 2)
    (h * torch.tensor(R["halo"][:, win])).sum().backward()
    res["halo"] = (_np(h), _np(x.grad))
    x = leaf(X[:, mine])
    s = SQ.frames_sum(x, fs)
    (s * torch.tensor(R["sum"][:, mine])).sum().backward()
    res["sum"] = (_np(s), _np(x.grad))
    x = leaf(X[:, mine].reshape(B * fs.local, S, C))
    c = SQ.clip_first_frame(x, fs)
    (c * torch.tensor(R["first"][:, mine][:, 0])).sum().backward()
    res["first"] = (_np(c), _np(x.grad))
    return res


# -- layers and the UNet ----------------------------------------------------

def _frames_rows(a: np.ndarray, T: int, fs) -> torch.Tensor:
    """The rows of this rank's frames of a [B*T, ...] array."""
    a = a.reshape(-1, T, *a.shape[1:])[:, fs.frames]
    return torch.tensor(np.ascontiguousarray(
        a.reshape(-1, *a.shape[2:])))


def module_grads(module, sd: dict, inputs: dict, grad_of: tuple, R, T,
                 fs, call):
    """Forward ``call(module, inputs)`` on this rank's frames (or the
    whole clip without ``fs``), backward of sum(out * R's rows), the
    gradients of the inputs ``grad_of`` and of every parameter (summed
    over the frames group)."""
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    ins = {}
    for k, v in inputs.items():
        if isinstance(v, tuple):            # ("per_clip", array)
            t = torch.tensor(v[1])
        elif fs is None:
            t = torch.tensor(v)
        else:
            t = _frames_rows(v, T, fs)
        ins[k] = t.requires_grad_(k in grad_of)
    out = call(module, ins)
    r = torch.tensor(R) if fs is None else _frames_rows(R, T, fs)
    (out * r.reshape(out.shape)).sum().backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in module.named_parameters()}
    if fs is not None:
        fs.mesh.all_reduce_(list(grads.values()), axis="frames")
    return {"out": _np(out), "inputs": {k: _np(ins[k].grad)
                                        for k in grad_of},
            "params": {n: _np(g) for n, g in grads.items()}}


def layer_cases(mesh, spec: dict | None, cases: dict) -> dict:
    """VideoResBlock, SpatialVideoTransformer and the tiny UNet (f32, its
    default remat), forward and backward, on ``spec``'s frames (one
    process: ``mesh`` and ``spec`` None)."""
    from street_crafter_tpu_torch.models.vdm import layers as PL
    from street_crafter_tpu_torch.models.vdm.unet import (UNetConfig,
                                                          VideoUNet)
    from street_crafter_tpu_torch.parallel.sequence import frames_shard
    torch.manual_seed(0)
    out = {}
    for name, c in cases.items():
        T = c["T"]
        fs = frames_shard(_mesh(spec), T) if spec is not None else None
        L = T if fs is None else fs.local
        if name == "resblock":
            mod = PL.VideoResBlock(c["C"], c["emb"], c["C"])

            def call(m, i, L=L):
                return m(i["x"], i["emb"], L, fs)
        elif name == "svt":
            mod = PL.SpatialVideoTransformer(c["C"], c["heads"], c["dh"], 1,
                                             48)

            def call(m, i, L=L):
                return m(i["x"], i["ctx"], L, fs)
        else:
            cfg = UNetConfig.tiny()
            if c.get("remat_policy"):
                import dataclasses
                cfg = dataclasses.replace(cfg,
                                          remat_policy=c["remat_policy"])
            mod = VideoUNet(cfg)

            def call(m, i, L=L):
                return m(i["x"], i["t"], i["ctx"], i["y"], num_frames=L,
                         cond_mask=i["cm"], guidance_input=i["g"],
                         guidance_scale=i["gs"], frames=fs)
        out[name] = module_grads(mod, c["sd"], c["inputs"], c["grad_of"],
                                 c["R"], T, fs, call)
    return out


def sharded_loss(mesh, spec: dict, latents, draws, model_w: float) -> dict:
    """``diffusion_loss`` (additional loss on) with a frame-local denoiser
    D(x) = w x + (1 - w) tanh(x) / (1 + sigma), on ``spec``'s frames (one
    process: ``spec`` None): the loss, the scalars and dloss / dw, summed
    over the frames group."""
    from street_crafter_tpu_torch.models.vdm.loss import (LossDraws,
                                                          diffusion_loss)
    from street_crafter_tpu_torch.parallel.sequence import frames_shard
    B, T = latents.shape[:2]
    fs = frames_shard(_mesh(spec), T) if spec is not None else None
    mine = slice(0, T) if fs is None else fs.frames
    w = torch.tensor(model_w, requires_grad=True)

    def dfn(x, sigma, cm):
        s = sigma.reshape(-1, 1, 1, 1)
        return w * x + (1 - w) * torch.tanh(x) / (1 + s)

    def rows(a):
        a = np.asarray(a)
        a = a.reshape(B, T, *a.shape[1:])[:, mine]
        return torch.tensor(np.ascontiguousarray(
            a.reshape(-1, *a.shape[2:])))
    ld = LossDraws(torch.tensor(draws[0]), rows(draws[1]), rows(draws[2]),
                   rows(draws[3]))
    lat = torch.tensor(np.ascontiguousarray(latents[:, mine])).reshape(
        -1, *latents.shape[2:])
    loss, sc = diffusion_loss(dfn, lat, ld, num_frames=lat.shape[0] // B,
                              use_additional_loss=True, frames=fs)
    loss.backward()
    vals = torch.stack([loss.detach(), w.grad] + [sc[k].detach()
                                                 for k in sorted(sc)])
    if fs is not None:
        fs.mesh.all_reduce_([vals], axis="frames")
    return {"loss": float(vals[0]), "dw": float(vals[1]),
            "scalars": {k: float(v) for k, v in zip(sorted(sc), vals[2:])}}


def gs_steps_on(mesh, spec: dict, *args) -> dict:
    """``tests.torch_dp_ranks.gs_steps`` on the mesh of ``spec``."""
    from tests import torch_dp_ranks as R
    return R.gs_steps(_mesh(spec), *args)


def suite(mesh, jobs: list) -> dict:
    """Several of this module's functions in one spawn: ``jobs`` is a list
    of (name, function name, arguments); returns {name: result}."""
    return {name: globals()[fn](mesh, *args) for name, fn, args in jobs}


# -- frames-sharded sampling -------------------------------------------------

SAMPLE_T, SAMPLE_STEPS = 4, 3


def sample_engine(sd: dict):
    from street_crafter_tpu_torch.models.vdm import weights as PW
    from street_crafter_tpu_torch.models.vdm.engine import (
        EngineConfig, VideoDiffusionEngine)
    eng = VideoDiffusionEngine(EngineConfig.tiny(num_frames=SAMPLE_T,
                                                 num_steps=SAMPLE_STEPS),
                               "cpu")
    PW.load_state_dicts(eng, {p: {k: torch.tensor(a) for k, a in s.items()}
                              for p, s in sd.items()})
    return eng


def sampling(mesh, spec: dict, sd: dict, guide, cond, render, noise,
             noise_sds, runner: bool) -> dict:
    """``sample_on_mesh`` on ``spec``'s mesh (one process: ``spec``
    None, ``engine.sample``) with the given noise, without and with the SDS
    start; with ``runner``, ``DiffusionRunner._sample`` with the mesh and
    the chunked decode of two latent clips with the frames ranks sharing
    the chunks."""
    from street_crafter_tpu_torch.parallel.sample import sample_on_mesh
    from street_crafter_tpu_torch.parallel.sequence import FramesShard
    from street_crafter_tpu_torch.runner.diffusion import DiffusionRunner
    eng = sample_engine(sd)
    m = _mesh(spec) if spec is not None else None
    g, c = torch.tensor(guide), torch.tensor(cond)

    def run(**kw):
        if m is None:
            return eng.sample(g, c, **kw).numpy()
        return sample_on_mesh(eng, g, c, m, **kw).numpy()
    out = {"plain": run(noise=torch.tensor(noise)),
           "sds": run(noise=torch.tensor(noise_sds),
                      render_images=torch.tensor(render), sds_scale=0.5)}
    if runner:
        r = DiffusionRunner(None, eng, height=32, width=32, mesh=m)
        out["runner"] = r._sample(guide, cond, None, None)
        fs = FramesShard(m, SAMPLE_T) if m is not None else None
        z = np.random.default_rng(8).normal(size=(7, 16, 16, 4)).astype(
            np.float32)
        out["decode"] = [eng.decode_latents_chunked(
            torch.tensor(z[:n]), chunk=4, overlap=ov, frames=fs).numpy()
            for n, ov in ((7, 3), (6, 2))]
    return out


def gating(mesh) -> dict:
    """``sampling_mesh_from_cfg`` with and without ``shard_sample`` in a
    group of more than one rank."""
    from street_crafter_tpu_torch.config import Config
    from street_crafter_tpu_torch.runner.diffusion import \
        sampling_mesh_from_cfg
    out = {}
    for flag in (False, True):
        cfg = Config(dict(device="cpu", diffusion=dict(shard_sample=flag),
                          mesh=dict(axes=dict(data=1, frames=-1))))
        m = sampling_mesh_from_cfg(cfg)
        out[flag] = None if m is None else dict(m.shape)
    return out


def vdm_sample_main(mesh, cfg_path: str, model_path: str) -> dict:
    """``runner.vdm_sample.main`` on every rank, each with a model path of
    its own (rank 0's is ``model_path``)."""
    import os
    from street_crafter_tpu_torch.runner import vdm_sample
    mp = model_path if mesh.rank == 0 else f"{model_path}_{mesh.rank}"
    res = vdm_sample.main(["--config", cfg_path, f"model_path={mp}",
                           "mesh.axes.frames=2",
                           "diffusion.shard_sample=true"])
    return {"frames": res["frames"], "clips": res["clips"],
            "wrote": os.path.isdir(mp) and bool(os.listdir(mp))}


# -- the frames-sharded fine-tune -------------------------------------------

VDM_T = 4


def vdm_sp_steps(mesh, spec: dict | None, mode: str, policy: str, sd: dict,
                 state: dict, nb: dict, draws_seq: list) -> dict:
    """From the whole train state ``state`` (numpy), one step for each of
    ``draws_seq`` on the numpy batch ``nb`` ([B, T, ...], this rank's part
    of it over ``spec``'s mesh; one process: ``spec`` None), the tiny
    engine at T = VDM_T under the remat ``policy``, the trainer's
    optimizer state sharded by ``mode`` ("zero2" or "fsdp"). Returns each
    step's loss and the gathered state."""
    import dataclasses

    from street_crafter_tpu_torch.models.vdm import weights as PW
    from street_crafter_tpu_torch.models.vdm.conditioner import Conditioning
    from street_crafter_tpu_torch.models.vdm.engine import (
        EngineConfig, VideoDiffusionEngine)
    from street_crafter_tpu_torch.parallel.sharding import (
        ShardingRules, shard_batch_for_mesh)
    from street_crafter_tpu_torch.training.vdm_trainer import VDMTrainer
    from tests import torch_dp_ranks as R
    cfg = EngineConfig.tiny(num_frames=VDM_T)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, remat_policy=policy))
    eng = VideoDiffusionEngine(cfg, "cpu", training=True)
    PW.load_state_dicts(eng, {p: {k: torch.tensor(a) for k, a in s.items()}
                              for p, s in sd.items()})
    m = _mesh(spec) if spec is not None else None
    if m is not None:
        nb = shard_batch_for_mesh(nb, m, VDM_T)
    batch = {"latents": torch.tensor(nb["latents"]),
             "guidance_latents": torch.tensor(nb["guidance_latents"]),
             "cond": Conditioning(*map(torch.tensor, nb["cond"]))}
    rules = None if m is None else ShardingRules(
        m, fsdp_params=mode == "fsdp")
    tr = VDMTrainer(eng, lr=R.VDM_LR, group_flags=R.VDM_FLAGS,
                    slow_scale=0.0, state=R.vdm_state_torch(state),
                    rules=rules)
    losses = [tr.train_step(batch, draws=R.vdm_draws(d))["loss"]
              for d in draws_seq]
    return {"losses": losses, "state": R.vdm_state_numpy(tr.whole_state()),
            "module": {n: p.detach().numpy().copy()
                       for n, p in tr.params.items()}}


# -- the W8A8 eval UNet -------------------------------------------------------

def quant_unet(mesh, spec: dict | None, sd: dict, inputs: dict,
               T: int) -> dict:
    """The tiny UNet with ``quant_convs`` (f32 weights, no gradients) on
    ``spec``'s frames (one process: ``mesh`` and ``spec`` None): its output,
    the input of every quantized convolution (as it reaches the int8
    convolution, this rank's frames) and the launches of ``ops.int8_conv``.
    ``inputs`` as ``layer_cases``' (a ("per_clip", array) pair is not
    split)."""
    import dataclasses

    from street_crafter_tpu_torch.models.vdm.unet import (UNetConfig,
                                                          VideoUNet)
    from street_crafter_tpu_torch.ops import int8_conv as Q
    from street_crafter_tpu_torch.parallel.sequence import frames_shard
    fs = frames_shard(_mesh(spec), T) if spec is not None else None
    L = T if fs is None else fs.local
    unet = VideoUNet(dataclasses.replace(UNetConfig.tiny(),
                                         quant_convs=True))
    unet.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    ins = {}
    for k, v in inputs.items():
        if isinstance(v, tuple):
            ins[k] = torch.tensor(v[1])
        else:
            ins[k] = torch.tensor(v) if fs is None else _frames_rows(v, T, fs)
    seen = []
    products = Q.int8_products_reference

    def record(x, *args, **kw):
        seen.append(_np(x))
        return products(x, *args, **kw)
    Q.int8_products_reference = record
    Q.reset_launch_counts()
    try:
        with torch.no_grad():
            out = unet(ins["x"], ins["t"], ins["ctx"], ins["y"],
                       num_frames=L, cond_mask=ins["cm"],
                       guidance_input=ins["g"], guidance_scale=ins["gs"],
                       frames=fs)
    finally:
        Q.int8_products_reference = products
    return {"out": _np(out), "inputs": seen, "launches": dict(Q.launches)}

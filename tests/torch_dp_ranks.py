"""Per-rank functions of the port's data-parallel tests (run by
``street_crafter_tpu_torch.parallel.mesh.run_ranks`` in spawned gloo
processes). Each takes the rank's ``Mesh`` first and returns picklable
results (numpy arrays, floats, dicts of them). This module imports no JAX,
so the children start without it."""

import numpy as np
import torch


def bridge_x2(mesh, x: np.ndarray) -> dict:
    """The SPMD bridge: the wrapped x2 (plain version on CPU tensors) on
    this rank's shard of the leading dim, gathered; and the identity
    without axes."""
    from street_crafter_tpu_torch.parallel import kernel_shard as KS
    KS.reset_launch_counts()
    xt = torch.from_numpy(x)
    with KS.kernel_sharding(mesh, ("data",)):
        out = KS.wrap_kernel(KS.x2, (x.ndim,), x.ndim)(xt)
    counts = dict(KS.launches)
    with KS.kernel_sharding(mesh, ()):
        same = KS.wrap_kernel(KS.x2, (x.ndim,), x.ndim) is KS.x2
    return {"out": out.numpy(), "counts": counts, "identity": same,
            "rank": mesh.rank, "world": mesh.world_size}


def collectives(mesh) -> dict:
    """all_reduce (sum, max), all_gather along dims 0 and 1, broadcast."""
    r = mesh.rank
    a = torch.tensor([1.0 + r, 10.0 * r])
    mesh.all_reduce_([a])
    b = torch.tensor([3.0 - r])
    mesh.all_reduce_([b], op="max")
    g0 = mesh.all_gather(torch.full((1, 2), float(r)), 0)
    g1 = mesh.all_gather(torch.full((2, 1), float(r)), 1)
    c = torch.tensor([float(r)])
    mesh.broadcast_([c], src=1)
    return {"sum": a.numpy(), "max": b.numpy(), "g0": g0.numpy(),
            "g1": g1.numpy(), "bcast": c.numpy()}


def staged_collectives(mesh) -> dict:
    """all_reduce_ (sum, max) and broadcast_ from rank 1 over float32,
    float64 and int64 tensors (one a strided view), staged through host
    buckets of 64 bytes, as gloo with CUDA tensors stages them. Returns,
    by collective, [the results, what every rank's inputs give], the
    latter computed here from each rank's seed."""
    import copy
    from street_crafter_tpu_torch.parallel import mesh as M

    class Staged(M.Mesh):
        _staged = True

    staged = copy.copy(mesh)
    staged.__class__ = Staged
    M.STAGE_BUCKET_BYTES = 64

    def tensors(r):
        g = torch.Generator().manual_seed(3 + r)
        return [torch.randn(6, 8, generator=g)[:, ::2],
                torch.randn(37, generator=g, dtype=torch.float64),
                torch.arange(10) * (r + 1), torch.randn(3, 3, generator=g)]

    ranks = [tensors(r) for r in range(mesh.world_size)]
    want = {"sum": [sum(ts) for ts in zip(*ranks)],
            "max": [torch.stack(ts).amax(0) for ts in zip(*ranks)],
            "bcast": ranks[1]}
    out = {}
    for name, kw in (("sum", {}), ("max", {"op": "max"}),
                     ("bcast", {"src": 1})):
        ts = tensors(mesh.rank)
        if name == "bcast":
            staged.broadcast_(ts, **kw)
        else:
            staged.all_reduce_(ts, **kw)
        out[name] = [[t.numpy().copy() for t in ts],
                     [t.numpy().copy() for t in want[name]]]
    return out


def fail_on_rank_1(mesh) -> int:
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


# -- camera-batched GS training ---------------------------------------------

def gs_cameras(cams: list) -> list:
    """Port cameras from (w2c [4, 4], K [3, 3], width, height) tuples."""
    from street_crafter_tpu_torch.datasets.cameras import Camera
    return [Camera.from_extrinsic(w2c, K, w, h) for w2c, K, w, h in cams]


def gs_batches(targets: list) -> list:
    return [{"gt_image": torch.tensor(t), "frame_idx": 0, "frame": 0.0,
             "cam_id": 0} for t in targets]


def gs_steps(mesh, cfg: dict, state0: dict, cams: list, targets: list,
             order: list, densify_after: int, threshold: float) -> dict:
    """``len(order)`` camera-batched steps from ``state0`` (a numpy train
    state) under the config ``cfg`` (a plain dict): step i trains on the
    cameras ``order[i]`` (B of them, this rank's B / W), a densify after
    step ``densify_after``. Returns the state (numpy), each step's loss
    and the valid counts around the densify."""
    from street_crafter_tpu_torch.config import Config
    from street_crafter_tpu_torch.models.gs.convert import (
        train_state_from_dict, train_state_to_numpy)
    cfg = Config(cfg)
    from street_crafter_tpu_torch.training.gs_trainer import (
        check_replicated, make_densify_step, make_train_step)
    state = train_state_from_dict(state0)
    cam_t, batches = gs_cameras(cams), gs_batches(targets)
    B = len(order[0])
    step = make_train_step(cfg, None, spatial_lr_scale=1.0, batch_size=B,
                           mesh=mesh)
    dcfg = cfg.clone()
    dcfg.optim.densify_grad_threshold = threshold
    densify = make_densify_step(dcfg)
    gen = torch.Generator().manual_seed(5)
    mine = mesh.local_slice(B) if mesh is not None else slice(0, B)
    losses, n_valid = [], []
    for i, idx in enumerate(order):
        idx = idx[mine]
        _, scalars = step(state, [cam_t[j] for j in idx],
                          [batches[j] for j in idx])
        losses.append(float(scalars["loss"]))
        if i == densify_after:
            before = state.params.bkgd.num_valid()
            densify(state, gen, 10.0)
            check_replicated(state, mesh)
            n_valid.append((before, state.params.bkgd.num_valid()))
    return {"state": train_state_to_numpy(state), "losses": losses,
            "n_valid": n_valid}


def gs_train_main(mesh, path: str, model_path: str, opts: list) -> dict:
    """``runner.train.main`` on every rank."""
    from street_crafter_tpu_torch.models.gs.convert import \
        train_state_to_numpy
    from street_crafter_tpu_torch.runner.train import main
    trainer = main(["--config", path, f"model_path={model_path}", *opts])
    return {"state": train_state_to_numpy(trainer.state),
            "rank": trainer.mesh.rank if trainer.mesh is not None else 0}


# -- the data-parallel fine-tune --------------------------------------------

VDM_T = 2
VDM_LR = 1e-3
VDM_FLAGS = {"slow_temporal_layers": True}


def vdm_state_numpy(state) -> dict:
    d = state.to_dict()
    return {k: ({n: t.detach().cpu().numpy() for n, t in v.items()}
                if k in ("masters", "mu", "nu", "ema") else v)
            for k, v in d.items()}


def vdm_state_torch(d: dict):
    from street_crafter_tpu_torch.training.vdm_trainer import VDMTrainState
    return VDMTrainState.from_dict({k: ({n: torch.tensor(a)
                                         for n, a in v.items()}
                                        if isinstance(v, dict)
                                        and k != "count" else v)
                                    for k, v in d.items()})


def vdm_draws(d: tuple):
    from street_crafter_tpu_torch.models.vdm.loss import LossDraws
    from street_crafter_tpu_torch.training.vdm_trainer import StepDraws
    keep, loss = d
    return StepDraws(torch.tensor(keep), LossDraws(*map(torch.tensor, loss)))


def vdm_batch(nb: dict, mesh) -> dict:
    """This rank's clips of a numpy batch, as the trainer's tensors."""
    from street_crafter_tpu_torch.models.vdm.conditioner import Conditioning
    from street_crafter_tpu_torch.parallel.sharding import shard_pytree_batch
    if mesh is not None:
        nb = shard_pytree_batch(nb, mesh)
    return {"latents": torch.tensor(nb["latents"]),
            "guidance_latents": torch.tensor(nb["guidance_latents"]),
            "cond": Conditioning(*map(torch.tensor, nb["cond"]))}


def vdm_engine(sd: dict):
    from street_crafter_tpu_torch.models.vdm import weights as PW
    from street_crafter_tpu_torch.models.vdm.engine import (
        EngineConfig, VideoDiffusionEngine)
    eng = VideoDiffusionEngine(EngineConfig.tiny(num_frames=VDM_T), "cpu",
                               training=True)
    PW.load_state_dicts(eng, {p: {k: torch.tensor(a) for k, a in s.items()}
                              for p, s in sd.items()})
    return eng


def vdm_rules(mesh, mode: str):
    from street_crafter_tpu_torch.parallel.sharding import ShardingRules
    if mesh is None:
        return None
    return ShardingRules(mesh, fsdp_params=mode == "fsdp",
                         zero=mode != "ddp")


def vdm_dp(mesh, sd: dict, state: dict, nb: dict, draws: tuple,
           grads: dict, draws_seq: list, ckpt_dir: str | None) -> dict:
    """From the whole train state ``state`` (numpy): for each of DDP, ZeRO-2
    and FSDP (one process: once, "one", with ``accumulate`` = the number of
    clips, so that both sum the same per-clip gradients), one step on this
    rank's clips of ``nb`` with the global ``draws``, gathered; and the
    optimizer alone on the whole gradients ``grads``, gathered. Then
    ZeRO-2 over the draws of ``draws_seq`` (one step each), its losses and
    gathered state, written by rank 0 as a checkpoint under
    ``ckpt_dir``."""
    from street_crafter_tpu_torch.training.vdm_trainer import VDMTrainer
    from street_crafter_tpu_torch.utils.checkpoint import save_vdm_checkpoint
    eng = vdm_engine(sd)
    batch = vdm_batch(nb, mesh)

    def trainer(rules):
        return VDMTrainer(eng, lr=VDM_LR, group_flags=VDM_FLAGS,
                          slow_scale=0.0, state=vdm_state_torch(state),
                          rules=rules, accumulate=(
                              1 if mesh is not None
                              else batch["latents"].shape[0]))
    out = {}
    for mode in (("ddp", "zero2", "fsdp") if mesh is not None else ("one",)):
        tr = trainer(vdm_rules(mesh, mode))
        sc = tr.train_step(batch, draws=vdm_draws(draws))
        res = {"loss": sc["loss"], "state": vdm_state_numpy(tr.whole_state()),
               "module": {n: p.detach().numpy().copy()
                          for n, p in tr.params.items()}}
        tr = trainer(vdm_rules(mesh, mode))
        with torch.no_grad():
            tr._apply({k: torch.tensor(g) for k, g in grads.items()})
        res["applied"] = vdm_state_numpy(tr.whole_state())
        out[mode] = res
    tr = trainer(vdm_rules(mesh, "zero2"))
    losses = [tr.train_step(batch, draws=vdm_draws(d))["loss"]
              for d in draws_seq]
    whole = tr.whole_state()
    if ckpt_dir is not None and (mesh is None or mesh.rank == 0):
        save_vdm_checkpoint(ckpt_dir, whole.step, whole)
    out["steps"] = {"losses": losses, "state": vdm_state_numpy(whole)}
    return out


def vdm_train_main(mesh, cfg_path: str, opts: list) -> dict:
    """``runner.vdm_train.main`` on every rank."""
    from street_crafter_tpu_torch.runner import vdm_train
    res = vdm_train.main(["--config", cfg_path, *opts])
    tr = res["trainer"]
    return {"scalars": res["scalars"], "steps": res["steps"],
            "state": vdm_state_numpy(tr.whole_state())}


def batch_render(mesh, params: dict, cams: list) -> dict:
    """``make_sharded_renderer`` over ``cams`` (this rank renders its
    share, the ranks gather)."""
    from street_crafter_tpu_torch.models.gs.batch_render import (
        make_sharded_renderer, stack_cameras)
    from street_crafter_tpu_torch.models.gs.convert import params_from_dict
    from street_crafter_tpu_torch.ops import gs_raster as G
    p = params_from_dict(params)
    batch, (h, w) = stack_cameras(gs_cameras(cams))
    G.reset_launch_counts()
    out = make_sharded_renderer(mesh, w, h, sh_degree=1)(p, None, batch)
    return {k: v.numpy() for k, v in out.items()} | {
        "counts": dict(G.launches)}


# -- distillation on several ranks ------------------------------------------

def distill_loop(mesh, cfg: dict, meta: dict, state0: dict, lp: dict,
                 novel: list) -> dict:
    """The GS loop with one sampling event whose stand-in hook attaches
    ``novel`` (numpy images) to the novel views, from the train state
    ``state0`` (numpy) with the scene meta ``meta`` (numpy), on this rank
    of ``mesh`` (one process: None). The scene as ``runner.train`` builds
    it on several ranks (rank 0 first, then the others without a
    processor). Returns the drawn cameras (the first of each step and the
    whole batch), the losses (rank 0), each event's images and the
    state."""
    from street_crafter_tpu_torch.config import Config
    from street_crafter_tpu_torch.models.gs.convert import (
        meta_from_dict, train_state_from_dict, train_state_to_numpy)
    from street_crafter_tpu_torch.ops.lpips import lpips_distance
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.runner.train import GSTrainer
    cfg = Config(cfg)
    if mesh is None or mesh.rank == 0:
        scene = create_scene(cfg)
    if mesh is not None:
        mesh.barrier()
        if mesh.rank != 0:
            scene = create_scene(cfg, need_processor=False)
    scene.meta = meta_from_dict(meta)
    trainer = GSTrainer(cfg, scene, lpips_fn=lambda a, b: lpips_distance(
        lp, a, b), mesh=mesh)
    trainer.state = train_state_from_dict(state0)
    picks, batches, losses = [], [], []
    pick, fill = trainer.pick_camera, trainer.fill_camera_batch

    def recorded_pick(pool):
        info, is_novel = pick(pool)
        picks.append((is_novel, info.image_name))
        return info, is_novel

    def recorded_fill(info, is_novel, pool):
        infos = fill(info, is_novel, pool)
        batches.append([i.image_name for i in infos])
        return infos
    trainer.pick_camera = recorded_pick
    trainer.fill_camera_batch = recorded_fill

    def stand_in_hook(tr, iteration, scale):
        for info, img in zip(tr.scene.info.novel_view_cameras, novel):
            info._image = img
            info.metadata["diffusion_version"] = \
                info.metadata.get("diffusion_version", 0) + 1

    trainer.run(diffusion_hook=stand_in_hook,
                log_fn=lambda it, vals: losses.append(vals["loss"]))
    return {"picks": picks, "batches": batches, "losses": losses,
            "state": train_state_to_numpy(trainer.state)}


def distill_main(mesh, path: str, opts: list, resume_opts: list | None
                 ) -> dict:
    """``runner.train.main`` with the diffusion hook on this rank (one
    process: ``mesh`` None), then, with ``resume_opts``, rank 0 removes
    the last checkpoint and every rank resumes. Per run: the sampling
    events, the novel images and their versions, the state, the engines
    this rank built, whether its hook samples, and the diffusion PNGs and
    condition renders this rank wrote."""
    import os
    import shutil

    from street_crafter_tpu_torch.data_processor import pointcloud as PC
    from street_crafter_tpu_torch.models.gs.convert import \
        train_state_to_numpy
    from street_crafter_tpu_torch.runner import diffusion as DR
    from street_crafter_tpu_torch.runner import train as T
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    from street_crafter_tpu_torch.utils.checkpoint import checkpoint_dir
    log = {"engines": 0, "pngs": 0, "conditions": 0}
    events, samples = [], []
    build, save, splat = VS.build_engine, DR.save_image, \
        PC.PointCloudProcessor._splat
    make = T.make_diffusion_hook

    def counted(key, fn):
        def call(*a, **kw):
            log[key] += 1
            return fn(*a, **kw)
        return call

    def counting_hook(cfg, *m):
        hook = make(cfg, *m)
        samples.append(hook.samples)

        def event(trainer, iteration, scale):
            events.append(iteration)
            hook(trainer, iteration, scale)
        return event

    def run(args):
        events.clear()
        trainer = T.main(["--config", path, *args])
        novel = trainer.scene.info.novel_view_cameras
        return {"events": list(events),
                "images": [c._image for c in novel],
                "versions": [c.metadata.get("diffusion_version", 0)
                             for c in novel],
                "start_iter": trainer.start_iter,
                "state": train_state_to_numpy(trainer.state),
                "model_path": trainer.scene.model_path}

    VS.build_engine = counted("engines", build)
    DR.save_image = counted("pngs", save)
    PC.PointCloudProcessor._splat = counted("conditions", splat)
    T.make_diffusion_hook = counting_hook
    try:
        out = {"first": run(opts)}
        out["first_log"] = dict(log)
        if resume_opts is not None:
            if mesh is None or mesh.rank == 0:
                it = int(out["first"]["state"]["step"])
                shutil.rmtree(checkpoint_dir(out["first"]["model_path"], it))
            if mesh is not None:
                mesh.barrier()
            out["resumed"] = run(resume_opts)
    finally:
        VS.build_engine, DR.save_image = build, save
        PC.PointCloudProcessor._splat = splat
        T.make_diffusion_hook = make
    out.update(log=log, samples=samples,
               rank=0 if mesh is None else mesh.rank,
               files=sorted(os.listdir(os.path.join(
                   out["first"]["model_path"], "diffusion"))))
    return out


def condition_barrier(mesh, root: str) -> dict:
    """``DiffusionRunner._render_conditions`` on every rank, rank 0 alone
    with a processor (whose render takes a second and writes a file),
    then an all-reduce: whether the file was there when the call returned,
    and the sum."""
    import os
    import time
    import types

    from street_crafter_tpu_torch.runner.diffusion import DiffusionRunner
    path = os.path.join(root, "condition.png")

    class Processor:
        def render_conditions(self, cameras, objects_info):
            time.sleep(1.0)
            with open(path, "w") as f:
                f.write("png")

    scene = types.SimpleNamespace(
        processor=Processor() if mesh.rank == 0 else None,
        info=types.SimpleNamespace(metadata={"obj_meta": []}))
    engine = types.SimpleNamespace(cfg=types.SimpleNamespace(num_frames=4))
    runner = DiffusionRunner(scene, engine, mesh=mesh)
    runner._render_conditions([])
    seen = os.path.exists(path)
    total = torch.tensor([float(mesh.rank + 1)])
    mesh.all_reduce_([total])
    return {"seen": seen, "sum": float(total)}

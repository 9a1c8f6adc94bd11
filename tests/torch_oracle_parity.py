"""The distillation oracle (tests/test_distillation_oracle.py) run in both
packages from one starting point, iteration by iteration.

Both trainers start from the JAX package's initial train state (jittered
as tests/test_torch_distill.py jitters it, so that no two splats tie in
depth), read JAX's palette ground truth from disk (its ``write_gt_images``),
score with JAX's LPIPS stand-in filters and draw the same camera sequence
(both seed ``random.Random(cfg.seed)``). The oracle hook attaches the same
numpy novel images (JAX's palette render at the novel cameras) in both.
JAX trains through its XLA raster with ``max_intersects_*`` set to the
splat count (exact, as the port's), or with the JAX test's cap of 64
splats a tile (``--cap 64``; JAX alone, since the port has no cap).

Records the per-iteration losses of both, their relative drift, whether
the camera sequences agree, and the novel-view PSNR of each package's
final parameters (each rendered by its own package and, for the port's,
also by JAX's renderer after conversion).

    JAX_PLATFORMS=cpu python -m tests.torch_oracle_parity --iters 150 \
        --out oracle.json

(about 4 minutes for both runs in both packages on one CPU core).
"""

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

DH, DW = 64, 128
LPIPS_KEY = 0


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_config(scene_dir: str, model_path: str, iters: int, cap: int,
               oracle: bool):
    """tests/test_distillation_oracle.py's config; ``cap`` splats a tile
    (and a coarse tile) in JAX's XLA train raster."""
    from street_crafter_tpu.config import default_config
    c = default_config()
    c.source_path = scene_dir
    c.model_path = model_path
    c.data.cameras = [0]
    c.data.split_test = 2
    c.train.iterations = iters
    c.train.test_iterations = []
    c.train.checkpoint_iterations = []
    c.train.save_iterations = []
    c.train.log_interval = 1
    c.train.novel_view_prob = 0.4 if oracle else 0.0
    c.optim.capacity_bkgd = 2048
    c.optim.capacity_obj = 256
    c.optim.capacity_sky = 512
    c.optim.densify_from_iter = 100000
    c.optim.opacity_reset_interval = 100000
    c.render.novel_view.shift = [2.0]
    c.render.max_intersects_per_tile = cap
    c.render.max_intersects_per_coarse = max(cap, 4096)
    c.render.train_method = "xla"
    c.render.train_auto_capacity = False
    c.model.gaussian.sh_degree = 1
    c.optim.lpips_fallback = "random_features"
    if oracle:
        c.diffusion.use_diffusion = True
        c.diffusion.height = DH
        c.diffusion.width = DW
        c.diffusion.sample_iterations = [5]
        c.diffusion.sds_scales = [0.7]
        c.diffusion.masked_guidance_iter = 100000
    return c


def port_config(scene_dir: str, model_path: str, iters: int, oracle: bool):
    """tests/test_torch_distill_oracle.py's config on the CPU."""
    from tests.test_torch_distill_oracle import base_cfg
    c = base_cfg(os.path.dirname(model_path), scene_dir,
                 os.path.basename(model_path))
    c.train.iterations = iters
    c.train.log_interval = 1
    if oracle:
        c.train.novel_view_prob = 0.4
        c.diffusion.use_diffusion = True
        c.diffusion.height = DH
        c.diffusion.width = DW
        c.diffusion.sample_iterations = [5]
        c.diffusion.sds_scales = [0.7]
    return c


def start_state(jscene, seed: int = 0):
    """JAX's initial params, their colours and the actor's positions
    jittered (equal-depth splats sort differently under a stable sort and
    ``top_k``), as tests/test_torch_distill.py does."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)

    def jittered(pool, **scales):
        return pool.replace(**{k: getattr(pool, k) + jnp.asarray(rng.normal(
            0, sd, getattr(pool, k).shape), jnp.float32)
            for k, sd in scales.items()})

    return dataclasses.replace(
        jscene.params, bkgd=jittered(jscene.params.bkgd, features_dc=1e-4),
        actors=jittered(jscene.params.actors, xyz=1e-3, features_dc=1e-4),
        sky=jittered(jscene.params.sky, features_dc=1e-4))


def jax_render_novel(jscene, params) -> list:
    """JAX's eval render (XLA raster, its default caps) at the
    diffusion-size novel cameras, as the JAX oracle test scores them."""
    from street_crafter_tpu.models.gs.renderer import render_scene
    from street_crafter_tpu.runner.diffusion import diffusion_camera
    outs = []
    for info in jscene.info.novel_view_cameras:
        b = jscene.batch_for(info)
        outs.append(np.asarray(render_scene(
            params, jscene.meta, diffusion_camera(info, DH, DW),
            frame_idx=b["frame_idx"], frame=b["frame"], cam_id=b["cam_id"],
            timestamp=b.get("timestamp"), sh_degree=1, clamp=True)["rgb"]))
    return outs


def psnr(imgs, gts) -> float:
    return float(np.mean([10.0 * np.log10(1.0 / max(
        float(np.mean((a - b) ** 2)), 1e-12)) for a, b in zip(imgs, gts)]))


def run(iters: int = 150, cap: int | None = None, root: str | None = None,
        modes=("gs_only", "oracle"), port: bool = True,
        control: float = 0.0) -> dict:
    """Both runs (GS only, oracle) in JAX and, unless ``cap`` is set or
    ``port`` is false, in the port, from the same start."""
    _jax_cpu()
    import importlib.util
    import pathlib

    from street_crafter_tpu.ops.lpips import lpips_distance as j_lpips
    from street_crafter_tpu.ops.lpips import random_lpips_params
    from street_crafter_tpu.runner import create_scene as j_scene
    from street_crafter_tpu.runner.train import GSTrainer as JTrainer
    from street_crafter_tpu.training.gs_trainer import init_train_state
    from street_crafter_tpu_torch.models.gs.convert import (
        meta_from_dict, train_state_from_dict)
    from street_crafter_tpu_torch.ops.lpips import lpips_distance as p_lpips
    from street_crafter_tpu_torch.runner import create_scene as p_scene
    from street_crafter_tpu_torch.runner.train import GSTrainer as PTrainer
    from tests.synthetic_scene import make_scene
    from tests.test_torch_distill_oracle import _render
    from tests.torch_port_helpers import (jax_scene_from_numpy,
                                          jax_tree_to_numpy)
    import jax

    spec = importlib.util.spec_from_file_location(
        "onchip_e2e", pathlib.Path(__file__).resolve().parent.parent
        / "scripts" / "run_onchip_e2e.py")
    onchip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(onchip)

    root = root or tempfile.mkdtemp()
    scene_dir = make_scene(root, num_frames=4, img_hw=(DH, DW))
    c0 = jax_config(scene_dir, os.path.join(root, "gt"), iters, 1024, False)
    onchip.write_gt_images(c0)
    jscene0 = j_scene(c0)
    n = sum(int(np.prod(p.valid.shape)) for p in
            (jscene0.params.bkgd, jscene0.params.actors, jscene0.params.sky))
    jcap = n if cap is None else cap
    lp = {k: np.asarray(v) for k, v in
          random_lpips_params(jax.random.PRNGKey(LPIPS_KEY)).items()}
    params0 = start_state(jscene0)
    start = jax_tree_to_numpy(init_train_state(params0))
    gt_params = onchip.palette_gt_params(jscene0)
    gt_novel = jax_render_novel(jscene0, gt_params)

    def hook(trainer, iteration, scale, *masked):
        for info, img in zip(trainer.scene.info.novel_view_cameras,
                             gt_novel):
            info._image = img
            info.metadata["diffusion_version"] = \
                info.metadata.get("diffusion_version", 0) + 1

    out = {"iters": iters, "splats": n, "jax_cap": jcap, "runs": {}}
    for mode in modes:
        oracle = mode == "oracle"
        res = {}
        jc = jax_config(scene_dir, os.path.join(root, "jax_" + mode), iters,
                        jcap, oracle)
        jscene = j_scene(jc)
        jt = JTrainer(jc, jscene, lpips_fn=lambda a, b: j_lpips(lp, a, b))
        jt.state = init_train_state(params0)
        runs = [("jax", jt)]
        if control:
            # JAX again from a start perturbed at the scale of float32
            # rounding: how fast round-off alone grows over the run
            jc2 = jax_config(scene_dir, os.path.join(root, "ctl_" + mode),
                             iters, jcap, oracle)
            jt2 = JTrainer(jc2, j_scene(jc2),
                           lpips_fn=lambda a, b: j_lpips(lp, a, b))
            rng = np.random.default_rng(1)
            bk = params0.bkgd
            jt2.state = init_train_state(dataclasses.replace(
                params0, bkgd=bk.replace(features_dc=bk.features_dc * (
                    1.0 + control * rng.standard_normal(
                        bk.features_dc.shape).astype(np.float32)))))
            runs.append(("jax_control", jt2))
        if port and cap is None:
            pc = port_config(scene_dir, os.path.join(root, "port_" + mode),
                             iters, oracle)
            ps = p_scene(pc)
            ps.meta = meta_from_dict(jax_tree_to_numpy(jscene.meta))
            pt = PTrainer(pc, ps, lpips_fn=lambda a, b: p_lpips(lp, a, b))
            pt.state = train_state_from_dict(start)
            runs.append(("port", pt))
        for name, trainer in runs:
            seq, losses = [], []
            pick = trainer.pick_camera

            def recorded(pool, pick=pick, seq=seq):
                info, is_novel = pick(pool)
                seq.append((bool(is_novel), info.image_name))
                return info, is_novel
            trainer.pick_camera = recorded
            trainer.run(diffusion_hook=hook if oracle else None,
                        log_fn=lambda it, v, losses=losses:
                        losses.append(float(v["loss"])))
            res[name] = {"losses": losses, "seq": seq}
        res["jax"]["psnr"] = psnr(jax_render_novel(jscene, jt.state.params),
                                  gt_novel)
        if "port" in res:
            res["port"]["psnr"] = psnr(
                [_render(ps, pt.state.params, info,
                         diffusion_camera_port(info), 1)
                 for info in ps.info.novel_view_cameras], gt_novel)
            from street_crafter_tpu_torch.models.gs.convert import (
                params_to_dict)
            jp, _ = jax_scene_from_numpy(params_to_dict(pt.state.params),
                                         None)
            res["port"]["psnr_jax_render"] = psnr(
                jax_render_novel(jscene, jp), gt_novel)
            got = np.array(res["port"]["losses"])
            want = np.array(res["jax"]["losses"])
            res["same_sequence"] = res["port"]["seq"] == res["jax"]["seq"]
            drift = np.abs(got - want) / np.abs(want)
            res["drift"] = [float(d) for d in drift]
            res["max_drift"] = float(drift.max())
            res["first_over_2e-4"] = next(
                (i + 1 for i, d in enumerate(drift) if d > 2e-4), None)
        if "jax_control" in res:
            got = np.array(res["jax_control"]["losses"])
            want = np.array(res["jax"]["losses"])
            drift = np.abs(got - want) / np.abs(want)
            res["control_drift"] = [float(d) for d in drift]
            res["control_first_over_2e-4"] = next(
                (i + 1 for i, d in enumerate(drift) if d > 2e-4), None)
        res["n_novel"] = sum(s for s, _ in res["jax"]["seq"])
        out["runs"][mode] = res
    for name in ("jax", "port"):
        if all(name in out["runs"].get(m, {}) for m in modes):
            if set(modes) == {"gs_only", "oracle"}:
                out[f"{name}_gain_db"] = (out["runs"]["oracle"][name]["psnr"]
                                          - out["runs"]["gs_only"][name]
                                          ["psnr"])
    return out


def diffusion_camera_port(info):
    from street_crafter_tpu_torch.runner.diffusion import diffusion_camera
    return diffusion_camera(info, DH, DW)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--cap", type=int, default=None,
                    help="JAX's splats a tile (JAX alone); default exact")
    ap.add_argument("--port", type=int, default=1,
                    help="0: JAX alone")
    ap.add_argument("--control", type=float, default=0.0,
                    help="also JAX from a start whose background colours "
                         "are scaled by 1 + control * N(0, 1)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = run(args.iters, args.cap, port=bool(args.port),
              control=args.control)
    summary = {k: v for k, v in out.items() if k != "runs"}
    for mode, res in out["runs"].items():
        summary[mode] = {
            **{f"{n}_psnr": res[n]["psnr"] for n in ("jax", "port")
               if n in res},
            "port_psnr_jax_render": res.get("port", {}).get(
                "psnr_jax_render"),
            "same_sequence": res.get("same_sequence"),
            "max_drift": res.get("max_drift"),
            "first_over_2e-4": res.get("first_over_2e-4"),
            "control_first_over_2e-4": res.get("control_first_over_2e-4"),
            "n_novel": res["n_novel"]}
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()

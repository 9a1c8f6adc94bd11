"""Default configuration tree.

The same tree as ``street_crafter_tpu/config/defaults.py``, so a config
written for the JAX package loads here unchanged, plus the port's ``device``
key. The port reads only the keys it honours; README.md lists the TPU-only
keys it ignores.
"""

from __future__ import annotations

from .config import Config


def default_config() -> Config:
    return Config({
        # run identity / paths
        "workspace": ".",
        "task": "street_crafter",
        "exp_name": "default",
        "mode": "train",
        "source_path": "",
        "model_path": "",
        "resolution": -1,
        "loaded_iter": -1,
        "resume": True,
        "seed": 0,
        # torch device of the port's scene and renders ("cuda" or "cpu");
        # CUDA tensors always go through the hand-written kernels
        "device": "cuda",

        # parallel ranks (parallel/mesh.py), laid out in this order, the
        # last axis innermost
        "mesh": {
            # axis name -> size over the torch.distributed world (torchrun's
            # WORLD_SIZE ranks; 1 without torchrun); -1 means "all remaining
            # ranks", so data: -1 is the world size. data: GS cameras and
            # fine-tune clips split over the ranks (DDP, ZeRO-2 moments,
            # FSDP with vdm_train.fsdp); frames: the JAX design's clip-frame
            # sequence parallelism (parallel/sequence.py): each clip's
            # frames split over the axis in the fine-tune and, with
            # diffusion.shard_sample, in sampling; GS cameras are replicated
            # over it. The size must divide the clip's frames. No tensor
            # axis: the 1.5B UNet fits per card in bf16 (SURVEY §2.3).
            "axes": {"data": -1, "frames": 1},
            "dcn_axes": {},           # multi-slice: axis -> num_slices
        },
        "precision": {
            "compute_dtype": "bfloat16",
            "param_dtype": "float32",
            "raster_dtype": "float32",
        },

        "eval": {
            "skip_train": False, "skip_test": False, "skip_novel": False,
            "eval_train": False, "eval_test": True, "eval_novel": False,
            "visualize": False,
            # opt-in: evaluate with the cheap inference path (recall 0.85 +
            # bf16 compositing). Default False: reported PSNR uses training
            # fidelity (recall_target, f32).
            "fast": False,
        },

        "train": {
            "iterations": 30000,
            "test_iterations": [7000, 30000],
            "save_iterations": [7000, 30000],
            "checkpoint_iterations": [30000],
            "start_checkpoint": None,
            "novel_view_prob": 0.4,
            # cameras per training step (camera-DP over the mesh's data
            # axis; 1 = the reference's single-camera loop)
            "batch_size": 1,
            "reg_obj_acc_every": 5,
            "log_interval": 10,
        },

        "optim": {
            # learning rates (per-parameter-group, as in gaussian_model.py:287-315)
            "position_lr_init": 0.00016,
            "position_lr_final": 0.0000016,
            "position_lr_delay_mult": 0.01,
            "position_lr_max_steps": 30000,
            "feature_lr": 0.0025,
            "opacity_lr": 0.05,
            "scaling_lr": 0.005,
            "rotation_lr": 0.001,
            "semantic_lr": 0.01,
            "track_position_lr_init": 0.0005,
            "track_position_lr_final": 0.0001,
            "track_rotation_lr_init": 0.0001,
            "track_rotation_lr_final": 0.00001,
            "track_warmup_steps": 0,
            "sky_cube_map_lr": 0.01,
            "color_correction_lr": 0.001,
            "pose_correction_lr": 0.0001,
            # densification / pruning (gaussian_model.py:452-551)
            "percent_dense": 0.01,
            "densification_interval": 100,
            "opacity_reset_interval": 3000,
            "densify_from_iter": 500,
            "densify_until_iter": 15000,
            "densify_grad_threshold": 0.0002,
            # per-pool threshold overrides (gaussian_model_bkgd.py:101,
            # gaussian_model_actor.py:203); None -> densify_grad_threshold
            "densify_grad_threshold_bkgd": None,
            "densify_grad_threshold_obj": None,
            # reference semantics (gaussian_model_bkgd.py:102-105): True
            # selects the SIGNED-grad column, False (default) the gsplat
            # absgrad column — the flag name is inherited as-is
            "densify_grad_abs_bkgd": False,
            "densify_grad_abs_obj": False,
            "min_opacity": 0.005,
            "percent_big_ws": 0.1,
            "prune_big_points": False,
            "max_screen_size": 1.0,
            # fixed-capacity pools (TPU-specific: XLA static shapes)
            "capacity_bkgd": 2 ** 21,
            "capacity_obj": 2 ** 15,
            "capacity_sky": 2 ** 18,
            # loss weights (train.py:149-233)
            "lambda_l1": 1.0,
            "lambda_lpips": 0.01,
            "lpips_weights": "",   # npz from ops.lpips.convert_lpips_torch
            "allow_missing_lpips": False,  # waive the hard-fail when lpips
            # lambdas are >0 but weights are unavailable
            "lpips_fallback": "none",  # "random_features": seeded random-
            # filter VGG LPIPS stand-in when real weights are missing
            # (restores the multi-scale term dominating the reference's
            # novel-view loss, train.py:183-189; ops/lpips.py rationale)
            "lambda_dssim": 0.2,
            "lambda_sky": 0.0,
            "lambda_sky_scale": [],
            "lambda_semantic": 0.0,
            "lambda_reg": 0.0,
            "lambda_depth_lidar": 0.0,
            "lambda_color_correction": 0.0,
            "lambda_pose_correction": 0.0,
            "lambda_scale_flatten": 0.0,
            "lambda_opacity_sparse": 0.0,
            "lambda_novel": 0.1,
            "lambda_novel_l1": 0.1,
            "lambda_novel_lpips": 1.0,
            "lambda_novel_dssim": 0.1,
        },

        "model": {
            "gaussian": {
                "sh_degree": 3,
                "fourier_dim": 1,
                "fourier_scale": 1.0,
                "flip_prob": 0.0,
                "semantic_dim": 0,
            },
            "nsg": {
                "include_bkgd": True,
                "include_obj": True,
                "include_sky": True,
                "opt_track": False,
            },
            "sky": {"use_cube_map": False, "resolution": 1024,
                    "white_background": True},
            "use_color_correction": False,
            "color_correction": {"mode": "image", "use_sky": False,
                                 "use_mlp": False},
            "use_pose_correction": False,
            "pose_correction": {"mode": "image"},
        },

        "data": {
            "type": "Waymo",
            "white_background": False,
            "split_test": -1,
            "split_train": -1,
            "cameras": [0],
            "selected_frames": [-1, -1],
            "box_scale": 1.0,
            "extent": 20.0,
            "sphere_scale": 1.0,
            "use_colmap": False,
            "delta_frames": 10,
            "skip_dynamic": False,
        },

        "render": {
            "antialiasing": True,
            "bf16_composite": True,   # inference rendering only
            # (training and eval composite in f32 for fidelity)
            "recall_target": 0.95,       # training/eval approx_min_k recall
            "eval_recall_target": 0.85,  # fast-path (videos/bench) recall
            "scaling_modifier": 1.0,
            "fps": 10,
            "save_video": True,
            "save_image": True,
            "coord": "world",
            "tile_size": 16,
            "absgrad": True,
            "scale": 0.01,
            "use_ndc_scale": True,
            "use_knn_scale": False,
            "max_intersects_per_tile": 1024,
            # per-coarse-tile candidate capacity (static shape). The video
            # render entries upgrade this per trajectory from a stats probe
            # (auto_capacity, ops/gs_raster.pick_coarse_capacity) so dense
            # post-densification scenes keep zero COARSE drops (the chunked
            # phase-1 kernel compiles through >=16k; per-16px-row lists are
            # still VMEM-capped at 2048 — depth-ordered, so only the
            # farthest row tail can drop, reported in row_dropped stats).
            # Auto probing never picks BELOW this value (it is the floor
            # for frames the probe did not see). TRAINING (fused_train)
            # classes kc>=8192 are also compile-cleared on v5e (per-kernel
            # scoped-VMEM limit, gate-verified round 4) — set this higher
            # for dense post-densification scenes that report coarse drops
            # during training.
            "max_intersects_per_coarse": 4096,
            "auto_capacity": True,
            # overflow-tile escalation (round 4): when the probe finds a
            # MINORITY of tiles over the base capacity, re-render only
            # those at high capacity instead of raising the class for the
            # whole frame (ops/gs_raster_fused.py escalate_tiles) — the
            # gsplat pay-per-tile economics under static shapes. Set False
            # to force the old global-capacity upgrade.
            "escalate": True,
            # training raster backend: "auto" (Pallas fused fwd + analytic
            # bwd on TPU, XLA autodiff on CPU), "fused_train", or "xla"
            "train_method": "auto",
            "novel_view": {
                "name": "test",
                "start_frame": -1, "end_frame": -1,
                "shift": [2.0, 3.0],
                "rotate": 0.0,
                "steps": 10,
                "train_actor_distance_thresh": 1.5,
            },
        },

        "diffusion": {
            "use_diffusion": False,
            "tiny": False,          # test-size engine (no pretrained weights)
            # engine compute dtype (precision.compute_dtype analog for the
            # VDM stack); "" -> flax promotion (f32). Params stay f32.
            "compute_dtype": "bfloat16",
            # LoRA adapters on every attention block (attention.py add_lora;
            # pairs with param_groups.train_peft_adapters)
            "add_lora": False,
            "lora_rank": 16,
            "config_path": "",
            "ckpt_path": "",
            "height": 576,
            "width": 1024,
            "sample_iterations": [7000, 12000, 17000, 22000],
            "sds_scales": [0.7, 0.6, 0.4, 0.3],
            "window_size": 4,
            "sample_frames": 25,
            "num_steps": 50,
            "cfg_scale": 2.5,
            "cond_aug": 0.0,
            "fps_id": 10,
            "motion_bucket_id": 127,
            # shard sampling over the cfg.mesh axes when the process group
            # has more than one rank (torchrun): frames-axis SP at inference
            # (parallel/sample.py), every rank gets the whole window and
            # rank 0 writes. Requires sample_frames divisible by the frames
            # axis.
            "shard_sample": False,
            # engine params rest in host RAM between sampling events,
            # staged to the device per event (the reference's --low_vram
            # submodule-offload analog, sample_condition.py:52-77; required
            # on <=16 GB chips — see runner/diffusion.EngineParamStore).
            # "auto" = on for accelerator backends, off on CPU.
            "params_on_host": "auto",
            # the port's sampling knobs (read by models/vdm/weights.py):
            # chunked VAE decode (3-frame overlap) and encode
            "decode_chunk": 8,
            # seeded random weights when ckpt_path is empty: the std (times
            # 1/sqrt(fan_in)) of the layers the JAX package zero-initialises
            # (0 = zero, as there)
            "init_zero_layers_std": 0.0,
            "masked_guidance_iter": 7000,
            "acc_masked_guidance": False,
            "cond_masked_guidance": True,
            "save_diffusion_render": True,
            "force_render_condition": False,
        },

        # video-diffusion fine-tune (training.sh:11-24 + waymo_high_res_mix)
        "vdm_train": {
            "data_root": "",
            "subsets": ["waymo"],
            "probs": [1.0],          # reference mix: [0.9, 0.1] waymo/pandaset
            "postfix": "",
            "batch_size": 1,         # per-step clips; sharded over data axis
            "accumulate": 1,         # gradient accumulation micro-steps
            "samples_per_epoch": 8000,
            "num_workers": 4,        # PNG-decode process pool (torch
            # DataLoader-workers analog); 0 = single prefetch thread
            "fsdp": False,           # shard the f32 masters and the EMA
            # over the data axis besides the Adam moments (ZeRO-2, the
            # default on several ranks); the bf16 compute copy of the UNet
            # stays whole on each rank
            "epochs": 3,
            "lr": 1.0e-5,
            "grad_clip": 0.3,
            "ema_decay": 0.9999,
            "guidance_dropout": 0.15,
            # param-group recipe (diffusion_condition.py:298-355). The
            # StreetCrafter conditioned fine-tune freezes temporal layers
            # (waymo_high_res_mix.yaml:12-16: slow_temporal_layers True,
            # scale 0.)
            "slow_spatial_layers": False,
            "slow_spatial_layers_scale": 0.1,
            "slow_temporal_layers": True,
            "slow_temporal_layers_scale": 0.0,
            "train_peft_adapters": False,
            # LR-multiplier schedule (scheduler_config analog,
            # waymo_high_res_mix.yaml:163-170; "" = constant lr). Types:
            # lambda_linear | warmup_cosine (models/vdm/lr_schedule.py)
            "scheduler": {
                "type": "",
                "warm_up_steps": [0],
                "f_start": [1.0e-6],
                "f_max": [1.0],
                "f_min": [1.0],
                "cycle_lengths": [10_000_000_000_000],
            },
            "height": 576,
            "width": 1024,
            "num_frames": 25,
            "ckpt_every": 1000,
            "log_every": 50,
            # ImageLogger analog (train.py:318-475): sample + dump
            # inputs/targets/samples mp4s every N steps (0 = off);
            # log_images_steps overrides the sampler step count (0 = cfg)
            "log_images_every": 1000,
            "log_images_steps": 0,
        },

        "profiler": {"enabled": False, "trace_dir": None,
                     "start_iter": 10, "num_iters": 5},
    })

"""Sky-mask generation (port of
``street_crafter_tpu/data_processor/sky_mask.py``; the reference's
generate_sky_mask.py:34-150: GroundingDINO boxes + SAM segmentation on the
prompt "sky"). Two backends:

- ``sam``: GroundingDINO + segment-anything, as the reference, behind an
  import gate (neither ships with the port; install them on the
  preprocessing host). The orchestration takes injected callables.
- ``heuristic``: dependency-free: bright, low-texture pixels connected to
  the top image border, computed on ``device``. The JAX package grows each
  row by shifting its mask one pixel at a time until nothing changes; here
  each row takes, in one step, the cyclic runs of its candidate pixels that
  hold a seed (the JAX version's fixed point, ``np.roll``'s wrap from
  column 0 to W-1 included), so the mask is bit-equal to the JAX package's.
  The sweeps over rows stay sequential.

PNGs are read and written by the port's ``utils/png.py``.

CLI: python -m street_crafter_tpu_torch.data_processor.sky_mask \\
    --scene SCENE_DIR [--method heuristic] [--cams 0 1 2] [--device cuda]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.png import read_png, write_png


def _cyclic_runs_with_seed(cand: torch.Tensor,
                           seed: torch.Tensor) -> torch.Tensor:
    """[B, W] bool: the pixels of ``cand`` whose cyclic run (maximal run of
    True along the row, column W-1 next to column 0) holds a ``seed``."""
    B, W = cand.shape
    start = cand & ~torch.roll(cand, 1, dims=1)
    ids = torch.cumsum(start.to(torch.int32), dim=1)
    # a run that wraps: its tail (the last run id) joins the head (id 0)
    wraps = (cand[:, :1] & cand[:, -1:]) & (ids == ids[:, -1:])
    ids = torch.where(wraps, torch.zeros_like(ids), ids).long()
    flat = ids + torch.arange(B, device=cand.device)[:, None] * (W + 1)
    hit = torch.zeros(B * (W + 1), dtype=torch.int32, device=cand.device)
    hit.scatter_reduce_(0, flat.reshape(-1),
                        (seed & cand).to(torch.int32).reshape(-1), "amax")
    return cand & (hit[flat] > 0)


def _fill(cand: torch.Tensor) -> torch.Tensor:
    """The JAX package's row-sweep flood fill from the top border of a
    [B, H, W] candidate grid: twice a down sweep (each row grows from the
    row above, its diagonals and itself, then along its cyclic runs) and an
    up sweep (each row from the row below)."""
    H = cand.shape[1]
    mask = torch.zeros_like(cand)
    mask[:, 0] = cand[:, 0]
    for _ in range(2):
        for y in range(1, H):
            up = mask[:, y - 1]
            seed = (up | torch.roll(up, 1, dims=1) | torch.roll(up, -1, dims=1)
                    | mask[:, y])
            mask[:, y] |= _cyclic_runs_with_seed(cand[:, y], seed)
        for y in range(H - 2, -1, -1):
            mask[:, y] |= cand[:, y] & (mask[:, y + 1] | mask[:, y])
    return mask


def heuristic_sky_mask(img, brightness_thresh: float = 0.45,
                       grad_thresh: float = 0.06,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """[..., H, W, 3] float in [0, 1] -> bool mask [..., H, W] on
    ``device``. Sky = bright, low-gradient pixels connected to the top
    border. A batch of images is filled together."""
    x = img if isinstance(img, torch.Tensor) else torch.as_tensor(
        np.asarray(img))
    x = x.to(device=device, dtype=torch.float32)
    lead = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    # numpy's float32 mean over 3 channels: ((r + g) + b) / 3, a true
    # division (a tensor divisor: CUDA multiplies by the reciprocal of a
    # scalar one)
    s = (x[..., 0] + x[..., 1]) + x[..., 2]
    gray = s / torch.full_like(s, 3.0)
    gy = torch.zeros_like(gray)
    gy[:, 1:] = torch.abs(gray[:, 1:] - gray[:, :-1])
    gx = torch.zeros_like(gray)
    gx[:, :, 1:] = torch.abs(gray[:, :, 1:] - gray[:, :, :-1])
    smooth = (gx + gy) < torch.tensor(grad_thresh, dtype=torch.float32)
    bright = gray > torch.tensor(brightness_thresh, dtype=torch.float32)
    mask = _fill(smooth & bright)
    return mask.reshape(lead + mask.shape[1:])


def sam_sky_mask(img: np.ndarray, detect_fn, segment_fn,
                 box_threshold: float = 0.3, text_threshold: float = 0.25,
                 top_edge_px: int = 100) -> np.ndarray:
    """GroundingDINO "sky" boxes -> SAM masks, the reference orchestration
    (generate_sky_mask.py:105-152):

    - ``detect_fn(img_u8, caption, box_threshold, text_threshold)`` returns
      normalized cxcywh boxes [N, 4] (GroundingDINO predict contract);
    - boxes are converted to pixel xyxy and filtered to those whose TOP edge
      is within ``top_edge_px`` of the image top (the reference's sky-box
      prior, :126-128);
    - ``segment_fn(img_u8, boxes_xyxy_px)`` returns [N, H, W] masks (SAM
      predict_torch contract) which are OR-merged; no boxes -> all-zero.

    The callables are injected so the pipeline is testable with fixture
    predictors; ``build_sam_backend`` constructs the real (import-gated)
    pair, which runs on its own device.
    """
    H, W = img.shape[:2]
    boxes = np.asarray(detect_fn(img, "sky", box_threshold, text_threshold),
                       np.float32).reshape(-1, 4)
    if boxes.shape[0]:
        cx, cy, bw, bh = boxes.T
        xyxy = np.stack([cx - bw / 2, cy - bh / 2,
                         cx + bw / 2, cy + bh / 2], -1)
        xyxy = xyxy * np.array([W, H, W, H], np.float32)
        xyxy = xyxy[xyxy[:, 1] < top_edge_px]
    else:
        xyxy = np.zeros((0, 4), np.float32)
    if xyxy.shape[0] == 0:
        return np.zeros((H, W), bool)
    masks = np.asarray(segment_fn(img, xyxy))
    mask = np.zeros((H, W), bool)
    for m in masks.reshape(-1, H, W):
        mask |= m.astype(bool)
    return mask


def build_sam_backend(sam_checkpoint: str,
                      dino_repo: str = "ShilongLiu/GroundingDINO",
                      dino_ckpt: str = "groundingdino_swinb_cogcoor.pth",
                      dino_cfg: str = "GroundingDINO_SwinB.cfg.py",
                      device: str = "cuda"):
    """Real (detect_fn, segment_fn) pair, behind an import gate:
    groundingdino and segment-anything do not ship with the port; install
    them on the preprocessing host (generate_sky_mask.py:34-66)."""
    try:
        from groundingdino.models import build_model
        from groundingdino.util.inference import predict
        from groundingdino.util.slconfig import SLConfig
        from groundingdino.util.utils import clean_state_dict
        from huggingface_hub import hf_hub_download
        from segment_anything import SamPredictor, build_sam
    except ImportError as e:
        raise ImportError(
            "the SAM sky-mask backend needs groundingdino + "
            f"segment-anything; missing: {e.name}. Use --method heuristic "
            "or install them on the preprocessing host.") from e

    cfg_file = hf_hub_download(repo_id=dino_repo, filename=dino_cfg)
    model = build_model(SLConfig.fromfile(cfg_file))
    ckpt = torch.load(hf_hub_download(repo_id=dino_repo, filename=dino_ckpt),
                      map_location="cpu")
    model.load_state_dict(clean_state_dict(ckpt["model"]), strict=False)
    model.eval()
    sam = build_sam(checkpoint=sam_checkpoint).to(device)
    predictor = SamPredictor(sam)

    def detect_fn(img_u8, caption, box_threshold, text_threshold):
        import groundingdino.datasets.transforms as T
        from PIL import Image
        tf = T.Compose([T.RandomResize([800], max_size=1333), T.ToTensor(),
                        T.Normalize([0.485, 0.456, 0.406],
                                    [0.229, 0.224, 0.225])])
        timg, _ = tf(Image.fromarray(img_u8), None)
        boxes, _, _ = predict(model=model, image=timg, caption=caption,
                              box_threshold=box_threshold,
                              text_threshold=text_threshold, device=device)
        return boxes.cpu().numpy()

    def segment_fn(img_u8, boxes_xyxy):
        predictor.set_image(img_u8)
        tb = predictor.transform.apply_boxes_torch(
            torch.as_tensor(boxes_xyxy), img_u8.shape[:2]).to(device)
        masks, _, _ = predictor.predict_torch(
            point_coords=None, point_labels=None, boxes=tb,
            multimask_output=False)
        return masks[:, 0].cpu().numpy()

    return detect_fn, segment_fn


def generate_scene_sky_masks(scene_dir: str, cams=(0, 1, 2),
                             method: str = "heuristic",
                             skip_existing: bool = True,
                             sam_backend=None,
                             box_thresholds=None,
                             device: str | torch.device = "cuda",
                             **kw) -> int:
    """sky_mask/{name}.png for every image of ``cams``; returns the count
    written. ``box_thresholds``: per-cam box threshold list (the reference
    CLI's --box_threshold, one value or one per camera). ``sam_backend``: a
    (detect_fn, segment_fn) pair, from build_sam_backend or a test
    fixture. The heuristic runs on ``device``."""
    from ..datasets.waymo_layout import image_filename_to_cam
    img_dir = os.path.join(scene_dir, "images")
    out_dir = os.path.join(scene_dir, "sky_mask")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(img_dir)):
        if not name.endswith(".png") or \
                image_filename_to_cam(name) not in cams:
            continue
        out = os.path.join(out_dir, name)
        if skip_existing and os.path.exists(out):
            continue
        raw = read_png(os.path.join(img_dir, name))
        raw = np.repeat(raw, 3, -1) if raw.shape[-1] < 3 else raw[..., :3]
        if method == "heuristic":
            mask = heuristic_sky_mask(raw.astype(np.float32) / 255.0,
                                      device=device, **kw).cpu().numpy()
        else:
            cam = image_filename_to_cam(name)
            bt = 0.3
            if box_thresholds:
                bt = (box_thresholds[cam] if len(box_thresholds) > cam
                      else box_thresholds[0])
            mask = sam_sky_mask(raw.astype(np.uint8), *sam_backend,
                                box_threshold=bt, **kw)
        write_png(out, (mask * 255).astype(np.uint8))
        count += 1
    return count


def main(argv: list[str] | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="sky mask generation")
    p.add_argument("--scene", required=True)
    p.add_argument("--cams", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--method", choices=["heuristic", "sam"],
                   default="heuristic")
    p.add_argument("--force", action="store_true")
    p.add_argument("--sam_checkpoint", default="")
    p.add_argument("--box_threshold", nargs="+", type=float, default=[0.3])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    backend = None
    if args.method == "sam":
        backend = build_sam_backend(args.sam_checkpoint, device=args.device)
    n = generate_scene_sky_masks(args.scene, cams=args.cams,
                                 method=args.method, sam_backend=backend,
                                 box_thresholds=args.box_threshold,
                                 skip_existing=not args.force,
                                 device=args.device)
    print(f"wrote {n} masks")
    return n


if __name__ == "__main__":
    main()

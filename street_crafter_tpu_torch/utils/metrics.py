"""Metrics logging and profiling hooks (port of
``street_crafter_tpu/utils/metrics.py``).

Scalars go to a JSONL stream and images to PNG files (``utils/png.py``):
the GPU machine has neither tensorboard nor imageio. Traces come from
``torch.profiler`` over a configured iteration window, written as Chrome
traces.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

from .png import write_png


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                           buffering=1)

    def log_scalars(self, step: int, scalars: dict[str, Any],
                    prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({f"{prefix}{k}": float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def log_image(self, step: int, name: str, image) -> str:
        """[H, W, 3] in [0, 1] (or uint8) -> images/<name>_<step>.png."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
        path = os.path.join(self.log_dir, "images",
                            f"{name.replace('/', '_')}_{int(step):06d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, img)
        return path

    def close(self) -> None:
        self._jsonl.close()


class ProfilerHook:
    """torch.profiler trace over ``cfg.profiler``'s window (enabled,
    start_iter, num_iters, trace_dir)."""

    def __init__(self, cfg_profiler, default_dir: str):
        self.enabled = bool(cfg_profiler.get("enabled", False))
        self.start_iter = int(cfg_profiler.get("start_iter", 10))
        self.num_iters = int(cfg_profiler.get("num_iters", 5))
        self.trace_dir = cfg_profiler.get("trace_dir") or \
            os.path.join(default_dir, "traces")
        self._prof = None

    def step(self, iteration: int) -> None:
        if not self.enabled:
            return
        if iteration == self.start_iter and self._prof is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif (self._prof is not None
              and iteration >= self.start_iter + self.num_iters):
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"profiler trace written to {path}")

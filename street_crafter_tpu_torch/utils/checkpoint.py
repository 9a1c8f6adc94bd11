"""Scene checkpoints with torch.save / torch.load.

Same directory layout as ``street_crafter_tpu/utils/checkpoint.py``:
``model_path/checkpoints/iteration_{it}/``, newest found by
``search_max_iteration``. Each directory holds ``params.pt``, the scene
parameters as a nested dict of tensors (``models.gs.convert``).
"""

from __future__ import annotations

import os
import re

import torch

from ..models.gs.convert import params_from_dict, params_to_dict
from ..models.gs.scene import SceneParams

PARAMS_FILE = "params.pt"


def checkpoint_dir(model_path: str, iteration: int) -> str:
    return os.path.join(os.path.abspath(model_path), "checkpoints",
                        f"iteration_{iteration}")


def save_checkpoint(model_path: str, iteration: int,
                    params: SceneParams) -> str:
    path = checkpoint_dir(model_path, iteration)
    os.makedirs(path, exist_ok=True)
    torch.save(params_to_dict(params), os.path.join(path, PARAMS_FILE))
    return path


def search_max_iteration(model_path: str) -> int | None:
    root = os.path.join(model_path, "checkpoints")
    if not os.path.isdir(root):
        return None
    iters = [int(m.group(1)) for name in os.listdir(root)
             if (m := re.fullmatch(r"iteration_(\d+)", name))]
    return max(iters) if iters else None


def load_checkpoint(model_path: str, iteration: int | None = None,
                    device: torch.device | str = "cpu"
                    ) -> tuple[SceneParams | None, int | None]:
    """(params, iteration), or (None, None) when no checkpoint exists."""
    if iteration is None:
        iteration = search_max_iteration(model_path)
        if iteration is None:
            return None, None
    path = os.path.join(checkpoint_dir(model_path, iteration), PARAMS_FILE)
    state = torch.load(path, map_location=device, weights_only=True)
    return params_from_dict(state, device), iteration

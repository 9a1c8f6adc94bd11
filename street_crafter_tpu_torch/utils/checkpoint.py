"""Scene checkpoints with torch.save / torch.load.

Same directory layout as ``street_crafter_tpu/utils/checkpoint.py``:
``model_path/checkpoints/iteration_{it}/``, newest found by
``search_max_iteration``. Each directory holds ``params.pt``, the scene
parameters as a nested dict of tensors (``models.gs.convert``), and, when
written by the trainer, ``train_state.pt``: the rest of the train state
(Adam moments and counts, densify statistics, step), so a run resumes at
``it + 1``. A render loads ``params.pt`` only.
"""

from __future__ import annotations

import os
import re

import torch

from ..models.gs.convert import (params_from_dict, params_to_dict,
                                 train_state_from_dict, train_state_to_dict)
from ..models.gs.scene import SceneParams

PARAMS_FILE = "params.pt"
TRAIN_STATE_FILE = "train_state.pt"


def checkpoint_dir(model_path: str, iteration: int) -> str:
    return os.path.join(os.path.abspath(model_path), "checkpoints",
                        f"iteration_{iteration}")


def save_checkpoint(model_path: str, iteration: int, params: SceneParams,
                    train_state=None) -> str:
    path = checkpoint_dir(model_path, iteration)
    os.makedirs(path, exist_ok=True)
    torch.save(params_to_dict(params), os.path.join(path, PARAMS_FILE))
    if train_state is not None:
        rest = train_state_to_dict(train_state)
        del rest["params"]
        torch.save(rest, os.path.join(path, TRAIN_STATE_FILE))
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


def load_train_checkpoint(model_path: str, iteration: int | None = None,
                          device: torch.device | str = "cpu"):
    """(GSTrainState, iteration) of the newest (or given) checkpoint, or
    (None, None) when there is none; raises for a checkpoint written
    without its train state."""
    params, it = load_checkpoint(model_path, iteration, device)
    if params is None:
        return None, None
    path = os.path.join(checkpoint_dir(model_path, it), TRAIN_STATE_FILE)
    rest = torch.load(path, map_location=device, weights_only=True)
    return train_state_from_dict(rest, device, params=params), it

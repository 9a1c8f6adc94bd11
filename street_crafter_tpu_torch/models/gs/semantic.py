"""Per-Gaussian semantic channel (port of ``street_crafter_tpu/models/gs/
semantic.py``; reference gaussian_model.py:23-26, 45, 79, 90-95, 143-155,
191, 244-248, renderer hook street_gaussian_renderer.py:195-200, config
keys use_semantic / num_classes / semantic_mode / lambda_semantic).

Off in every published reference config, and kept as a sidecar so that it
does not touch the pools or their optimizer:

- ``SemanticField``: [cap, num_classes] logits aligned with a pool, with
  the reference's "logits" / "probabilities" activation modes;
- densify: ``densify_and_prune(..., extra={"semantic": field.logits})``
  carries the rows (children copy their parent's);
- rendering: ``render_flat(..., extra_channels=field.get_semantic())``
  composites them with the colour and returns them under "semantic"; on
  the card through kernels B and C at 4 + num_classes channels
  (``ops.gs_raster.MAX_CHANNELS``);
- ``semantic_loss``: pixel cross-entropy against an integer label map,
  times ``lambda_semantic``;
- PLY: trailing ``semantic_i`` properties (``utils.gs_ply``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class SemanticField:
    logits: torch.Tensor                  # [cap, num_classes]
    mode: str = "logits"

    @property
    def num_classes(self) -> int:
        return self.logits.shape[-1]

    def get_semantic(self) -> torch.Tensor:
        """The activation of ``mode`` (gaussian_model.py:244-248)."""
        if self.mode == "logits":
            return self.logits
        if self.mode == "probabilities":
            return torch.softmax(self.logits, dim=-1)
        raise ValueError(self.mode)


def init_semantic(capacity: int, num_classes: int,
                  labels: torch.Tensor | None = None, mode: str = "logits",
                  device=None) -> SemanticField:
    """A fresh field; optional [n] integer labels of the first n slots
    become one-hot logits (create_from_pcd)."""
    logits = torch.zeros((capacity, num_classes), dtype=torch.float32,
                         device=device)
    if labels is not None:
        labels = torch.as_tensor(labels, device=logits.device).long()
        logits[:labels.shape[0]] = F.one_hot(labels, num_classes).float()
    return SemanticField(logits=logits, mode=mode)


def semantic_loss(rendered: torch.Tensor,      # [H, W, num_classes] logits
                  labels: torch.Tensor,        # [H, W] int class ids
                  lambda_semantic: float = 0.0,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel cross-entropy of the composited logits, times
    ``lambda_semantic``; 0 when the weight is 0 (the reference default).
    With ``mask`` the mean is over the masked pixels."""
    if lambda_semantic == 0.0:
        return torch.zeros((), device=rendered.device)
    logp = torch.log_softmax(rendered, dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        m = mask.to(ce.dtype)
        ce = (ce * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        ce = ce.mean()
    return lambda_semantic * ce

"""Trained-Gaussian PLY export and import in the standard 3DGS attribute
layout (port of ``street_crafter_tpu/utils/gs_ply.py``).

Attribute order of the reference's ``construct_list_of_attributes``: x y z
nx ny nz, f_dc_* (channel-major: [N, F, 3] -> [N, 3, F] -> flat), f_rest_*
(same), opacity, scale_0..2, rot_0..3; float32, binary little-endian. A
single pool exports as element ``vertex`` (external 3DGS viewers load it
directly), a dict of pools as one ``vertex_<name>`` element per pool (the
reference's composite save). Optional per-pool [cap, K] semantic logits
ride as trailing ``semantic_i`` properties (gaussian_model.py:90-95,
143-155). Files written by the JAX package load here: this is how a scene
trained in JAX reaches the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.gs.params import GaussianPool


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pool_to_attributes(pool: GaussianPool, semantic=None
                       ) -> tuple[list[str], np.ndarray]:
    """Valid rows of a pool -> (attribute names, [n, D] float32 matrix);
    ``semantic`` [cap, K] (tensor or array) appends ``semantic_i``."""
    valid = _np(pool.valid)
    xyz = _np(pool.xyz)[valid]
    n = xyz.shape[0]
    f_dc = np.transpose(_np(pool.features_dc)[valid], (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(_np(pool.features_rest)[valid],
                          (0, 2, 1)).reshape(n, -1)
    opacity = _np(pool.opacity)[valid].reshape(n, 1)
    scale = _np(pool.scaling)[valid]
    rot = _np(pool.rotation)[valid]
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scale.shape[1])]
             + [f"rot_{i}" for i in range(rot.shape[1])])
    parts = [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scale, rot]
    if semantic is not None:
        sem = (_np(semantic) if torch.is_tensor(semantic)
               else np.asarray(semantic))[valid].reshape(n, -1)
        names += [f"semantic_{i}" for i in range(sem.shape[1])]
        parts.append(sem)
    mat = np.concatenate(parts, axis=1).astype(np.float32)
    return names, mat


def export_gaussians_ply(path: str | os.PathLike,
                         pools: dict[str, GaussianPool] | GaussianPool,
                         semantics=None) -> None:
    """Write one binary PLY of the valid Gaussians of ``pools``.
    ``semantics`` mirrors ``pools``: [cap, K] logits, or a dict of them by
    pool name (pools without an entry carry none)."""
    if isinstance(pools, GaussianPool):
        elements = [("vertex", *pool_to_attributes(pools, semantics))]
    else:
        semantics = semantics or {}
        elements = [(f"vertex_{name}",
                     *pool_to_attributes(p, semantics.get(name)))
                    for name, p in pools.items()]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0"]
    for el_name, names, mat in elements:
        header.append(f"element {el_name} {mat.shape[0]}")
        header += [f"property float {a}" for a in names]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for _, _, mat in elements:
            f.write(np.ascontiguousarray(mat, dtype="<f4").tobytes())


def _parse_elements(path) -> list[tuple[str, dict[str, np.ndarray]]]:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        if b"binary_little_endian" not in f.readline():
            raise ValueError(f"{path}: expected binary_little_endian")
        elements: list[tuple[str, int, list[str]]] = []
        while True:
            line = f.readline().strip().decode("ascii")
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] != "float":
                    raise ValueError(f"{path}: only float properties are "
                                     f"supported, got {line}")
                elements[-1][2].append(parts[2])
        out = []
        for el_name, count, props in elements:
            raw = np.frombuffer(f.read(4 * count * len(props)), dtype="<f4")
            mat = raw.reshape(count, len(props))
            out.append((el_name, {p: mat[:, i] for i, p in enumerate(props)}))
    return out


def _sorted_cols(cols: dict[str, np.ndarray], prefix: str) -> np.ndarray:
    names = sorted((k for k in cols if k.startswith(prefix)),
                   key=lambda s: int(s.rsplit("_", 1)[1]))
    return np.stack([cols[k] for k in names], axis=1)


def _attributes_to_pool(cols: dict[str, np.ndarray], capacity: int | None,
                        device) -> GaussianPool:
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    n = xyz.shape[0]
    f_dc = np.transpose(_sorted_cols(cols, "f_dc_").reshape(n, 3, -1),
                        (0, 2, 1))
    f_rest = np.transpose(_sorted_cols(cols, "f_rest_").reshape(n, 3, -1),
                          (0, 2, 1))
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} gaussians in file")

    def pad(a):
        a = np.concatenate([a, np.zeros((cap - n,) + a.shape[1:], a.dtype)])
        return torch.tensor(a.astype(np.float32), device=device)

    return GaussianPool(
        xyz=pad(xyz), features_dc=pad(f_dc), features_rest=pad(f_rest),
        scaling=pad(_sorted_cols(cols, "scale_")),
        rotation=pad(_sorted_cols(cols, "rot_")),
        opacity=pad(cols["opacity"].reshape(n, 1)),
        valid=torch.tensor(np.arange(cap) < n, device=device))


def import_gaussians_ply(path: str | os.PathLike, capacity: int | None = None,
                         device: torch.device | str = "cpu",
                         with_semantics: bool = False):
    """Read a 3DGS PLY back into pools: {model_name: pool}; a plain
    single-element ``vertex`` file maps to {"vertex": pool}. Pools are padded
    with invalid slots up to ``capacity``. With ``with_semantics`` also
    {model_name: [cap, K] f32 logits from the ``semantic_i`` properties
    (zero rows past the file's), or None}."""
    out, sems = {}, {}
    for el_name, cols in _parse_elements(path):
        name = (el_name[len("vertex_"):] if el_name.startswith("vertex_")
                else el_name)
        pool = _attributes_to_pool(cols, capacity, device)
        out[name] = pool
        sems[name] = None
        if any(k.startswith("semantic_") for k in cols):
            sem = _sorted_cols(cols, "semantic_").astype(np.float32)
            pad = pool.valid.shape[0] - sem.shape[0]
            sems[name] = torch.tensor(np.concatenate(
                [sem, np.zeros((pad, sem.shape[1]), np.float32)]),
                device=device)
    return (out, sems) if with_semantics else out

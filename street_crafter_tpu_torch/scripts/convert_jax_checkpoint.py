"""Convert the JAX package's checkpoints into the port's files, without JAX.

The JAX package writes its checkpoints with orbax's ``PyTreeCheckpointer``:
an OCDBT key-value store of zarr arrays beside a ``_METADATA`` JSON file,
whose ``tree_metadata`` names every leaf by its key path (dict keys,
sequence indices, and the field names of dataclasses and named tuples).
``read_orbax`` reads that with ``tensorstore`` alone (each leaf is the zarr
array at the path's keys joined by dots) and rebuilds the tree as nested
dicts and lists; a dict node also answers attribute access, so the
converters that take a JAX state object (``state.opt_state``,
``adam.mu``) take the tree as it is. Leaves orbax stores as None (optax's
empty states, masked leaves) come back as None.

Three kinds, through the port's converters:

- ``scene``: a scene checkpoint (``utils/checkpoint.py``: a GSTrainState,
  or scene parameters alone) -> ``checkpoints/iteration_N/params.pt`` and
  ``train_state.pt`` (``models/gs/convert.py``);
- ``vdm``: VDM parameters (``models/vdm/weights.py::save_vdm_params``) ->
  the port's parameter file, which ``diffusion.ckpt_path`` loads
  (``models/vdm/convert.py::engine_params_from_jax``);
- ``vdm_train``: a fine-tune's VDMTrainState ->
  ``checkpoints/iteration_N/vdm_train_state.pt``
  (``models/vdm/convert.py::vdm_train_state_from_jax``).

``vdm`` and ``vdm_train`` need the engine's configuration: the port's
config file and overrides, as ``runner.vdm_sample`` takes them.

    python -m street_crafter_tpu_torch.scripts.convert_jax_checkpoint \\
        scene JAX_MODEL_PATH PORT_MODEL_PATH [--iteration N]
    python -m street_crafter_tpu_torch.scripts.convert_jax_checkpoint \\
        vdm JAX_PARAMS_DIR OUT.pt [--config CFG] [key=value ...]
    python -m street_crafter_tpu_torch.scripts.convert_jax_checkpoint \\
        vdm_train JAX_MODEL_PATH PORT_MODEL_PATH [--iteration N] \\
        [--config CFG] [key=value ...]

Runs on the CPU; needs the ``tensorstore`` package (not the card's
machine's).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

SEQUENCE_KEY = 1          # orbax's key_type of a sequence index


class Node(dict):
    """A dict node of a restored tree; its keys read as attributes too."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading the JAX package's orbax checkpoints needs the "
            f"'tensorstore' package; missing: {e.name}") from e
    return tensorstore


def _finish(node):
    """Dict nodes keyed by sequence indices -> lists (None where orbax
    stored nothing)."""
    if isinstance(node, tuple):                   # (SEQUENCE_KEY, children)
        children = node[1]
        out = [None] * (max(children) + 1 if children else 0)
        for i, v in children.items():
            out[i] = _finish(v)
        return out
    if isinstance(node, Node):
        return Node({k: _finish(v) for k, v in node.items()})
    return node


def read_orbax(path: str) -> Node:
    """The pytree of an orbax ``PyTreeCheckpointer`` directory as nested
    ``Node`` dicts and lists of numpy arrays (0-d for scalars)."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True):
        raise NotImplementedError(f"{path}: a checkpoint without OCDBT")
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    kvstore = {"driver": "ocdbt", "base": f"file://{path}"}
    entries = [(e["key_metadata"], e["value_metadata"])
               for e in meta["tree_metadata"].values()]
    # every leaf opened, then read, concurrently in one shared context
    context = ts.Context()
    stored = [not v.get("skip_deserialize")
              and v.get("value_type") != "None" for _, v in entries]
    opens = [ts.open({"driver": driver, "kvstore": kvstore,
                      "path": ".".join(k["key"] for k in keys)},
                     context=context) if s else None
             for (keys, _), s in zip(entries, stored)]
    reads = [o.result().read() if o is not None else None for o in opens]
    root = Node()
    for (keys, _), r in zip(entries, reads):
        leaf = None if r is None else np.asarray(r.result())
        node = root
        for i, k in enumerate(keys):
            last = i == len(keys) - 1
            if k["key_type"] == SEQUENCE_KEY:
                key = int(k["key"])
                children = node[1]
            else:
                key = k["key"]
                children = node
            if last:
                children[key] = leaf
            else:
                nxt = keys[i + 1]["key_type"]
                if key not in children:
                    children[key] = ((SEQUENCE_KEY, {})
                                     if nxt == SEQUENCE_KEY else Node())
                node = children[key]
    return _finish(root)


def _iteration_dir(model_path: str, iteration: int | None) -> tuple[str, int]:
    from ..utils.checkpoint import checkpoint_dir, search_max_iteration
    if iteration is None:
        iteration = search_max_iteration(model_path)
        if iteration is None:
            raise FileNotFoundError(f"no checkpoints under {model_path}")
    return checkpoint_dir(model_path, iteration), iteration


def convert_scene(src_model_path: str, dst_model_path: str,
                  iteration: int | None = None) -> str:
    """A JAX scene checkpoint -> the port's params.pt (+ train_state.pt for
    a GSTrainState). Returns the port's checkpoint directory."""
    from ..models.gs.convert import params_from_dict, train_state_from_dict
    from ..utils.checkpoint import save_checkpoint
    src, it = _iteration_dir(src_model_path, iteration)
    tree = read_orbax(src)
    if "params" in tree and "step" in tree:
        state = train_state_from_dict(tree)
        return save_checkpoint(dst_model_path, it, state.params, state)
    return save_checkpoint(dst_model_path, it, params_from_dict(tree))


def engine_config(config: str | None, opts=()):
    """The EngineConfig of the port's config file (default config when
    None) with dotted overrides."""
    from ..config import default_config, load_config, merge_dotlist
    from ..models.vdm.weights import engine_from_config
    cfg = default_config()
    if config:
        cfg.merge(load_config(config))
    merge_dotlist(cfg, opts)
    return engine_from_config(cfg.diffusion)


def convert_vdm_params(src: str, dst: str, cfg) -> str:
    """JAX VDM parameters ({"unet", "vae", "clip"}) -> the port's
    parameter file at ``dst`` for an ``EngineConfig`` ``cfg``."""
    from ..models.vdm.convert import engine_params_from_jax
    from ..models.vdm.weights import save_vdm_state_dicts
    sds = engine_params_from_jax(read_orbax(src), cfg)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    save_vdm_state_dicts(dst, sds)
    return dst


def convert_vdm_train_state(src_model_path: str, dst_model_path: str, cfg,
                            iteration: int | None = None) -> str:
    """A JAX fine-tune checkpoint -> the port's vdm_train_state.pt."""
    from ..models.vdm.convert import vdm_train_state_from_jax
    from ..utils.checkpoint import save_vdm_checkpoint
    src, _ = _iteration_dir(src_model_path, iteration)
    state = vdm_train_state_from_jax(read_orbax(src), cfg)
    return save_vdm_checkpoint(dst_model_path, state.step, state)


def main(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser(
        description="convert a JAX package checkpoint into the port's files")
    p.add_argument("kind", choices=["scene", "vdm", "vdm_train"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--config", default=None,
                   help="the port's config (vdm, vdm_train): the engine")
    p.add_argument("opts", nargs="*", default=[],
                   help="config overrides, key=value")
    args = p.parse_args(argv)
    if args.kind == "scene":
        out = convert_scene(args.src, args.dst, args.iteration)
    elif args.kind == "vdm":
        out = convert_vdm_params(args.src, args.dst,
                                 engine_config(args.config, args.opts))
    else:
        out = convert_vdm_train_state(args.src, args.dst,
                                      engine_config(args.config, args.opts),
                                      args.iteration)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()

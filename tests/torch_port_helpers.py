"""Shared helpers for the street_crafter_tpu_torch parity tests: flatten the
JAX package's scene dataclasses into nested dicts of numpy arrays (the input
of ``street_crafter_tpu_torch.models.gs.convert.scene_from_numpy``)."""

import dataclasses

import numpy as np


def jax_tree_to_numpy(obj):
    """JAX dataclass / dict / array tree -> nested dicts of numpy arrays."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: jax_tree_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: jax_tree_to_numpy(v) for k, v in obj.items()}
    return np.asarray(obj)


def jax_scene_from_numpy(params: dict, meta: dict | None):
    """Nested dicts of numpy arrays -> the JAX package's SceneParams /
    SceneMeta (pools given as dicts of their fields)."""
    import jax.numpy as jnp

    from street_crafter_tpu.models.gs.params import GaussianPool
    from street_crafter_tpu.models.gs.scene import SceneMeta, SceneParams

    def leaf(k, v):
        if v is None:
            return None
        if k in ("bkgd", "actors", "sky"):
            return GaussianPool(**{f: jnp.asarray(x) for f, x in v.items()})
        if isinstance(v, dict):
            return {f: jnp.asarray(x) for f, x in v.items()}
        return jnp.asarray(v)

    jp = SceneParams(**{k: leaf(k, v) for k, v in params.items()})
    if meta is None:
        return jp, None
    jm = SceneMeta(**{k: (v if k == "fourier_scale" or v is None
                          else jnp.asarray(v)) for k, v in meta.items()})
    return jp, jm



def random_params(shapes, seed: int = 0):
    """Seeded random values for a JAX parameter tree given by its shapes
    (e.g. ``jax.eval_shape`` of an init, which is much cheaper than running
    it): kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), the rest
    (biases, mix factors, embeddings) N(0, 0.1^2). Every layer, also those
    the JAX package initialises to zero, carries signal in a parity test.
    Returns nested dicts of float32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = tuple(node.shape)
        x = rng.normal(size=shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(float(np.prod(shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x
    return walk(shapes, "")

"""Port parity: EWA projection, pool initialization and scene flattening of
street_crafter_tpu_torch against the JAX package on the same numpy inputs.

Tolerance: atol 1e-5 on float outputs (plus rtol 1e-6 where values reach
hundreds of pixels, whose f32 spacing alone is ~3e-5); ``radii`` and
``valid`` must match exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.gs import params as jparams
from street_crafter_tpu.models.gs import scene as jscene
from street_crafter_tpu.ops import gs_projection as jproj
from street_crafter_tpu.ops import knn as jknn
from street_crafter_tpu_torch.models.gs import params as tparams
from street_crafter_tpu_torch.models.gs import scene as tscene
from street_crafter_tpu_torch.models.gs.convert import scene_from_numpy
from street_crafter_tpu_torch.ops import gs_projection as tproj
from street_crafter_tpu_torch.ops import knn as tknn
from tests.torch_port_helpers import jax_scene_from_numpy, jax_tree_to_numpy

ATOL, RTOL = 1e-5, 1e-6


def close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def gaussians(rng, n):
    means = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                      rng.uniform(-2, 25, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(np.log(0.1), 1.2, (n, 3))).astype(np.float32)
    return means, quats, scales


@pytest.mark.parametrize("antialiasing", [True, False])
def test_project_gaussians(rng, antialiasing):
    means, quats, scales = gaussians(rng, 400)
    w2c = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    w2c[:3, 3] = [0.3, -0.1, 0.5]
    K = np.array([[55.0, 0, 32], [0, 55.0, 24], [0, 0, 1]], np.float32)
    mask = rng.random(400) > 0.1
    pj = jproj.project_gaussians(jnp.asarray(means), jnp.asarray(quats),
                                 jnp.asarray(scales), jnp.asarray(w2c),
                                 jnp.asarray(K), 64, 48,
                                 antialiasing=antialiasing,
                                 mask=jnp.asarray(mask))
    pt = tproj.project_gaussians(torch.tensor(means), torch.tensor(quats),
                                 torch.tensor(scales), torch.tensor(w2c),
                                 torch.tensor(K), 64, 48,
                                 antialiasing=antialiasing,
                                 mask=torch.tensor(mask))
    # the input exercises every cull: behind the camera, off screen, masked
    valid = np.asarray(pj.valid)
    assert 0.3 < valid.mean() < 0.95
    np.testing.assert_array_equal(pt.valid.numpy(), valid)
    np.testing.assert_array_equal(pt.radii.numpy(), np.asarray(pj.radii))
    for name in ("u", "v", "depths", "compensations"):
        close(getattr(pt, name), getattr(pj, name))
    # conics of near-degenerate splats reach ~1/EPS2D; compare where valid
    for name in ("conic_a", "conic_b", "conic_c"):
        close(getattr(pt, name)[pt.valid],
              np.asarray(getattr(pj, name))[valid])


def test_knn_and_init_pool(rng):
    pts = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    # brute-force |x-y|^2 (port) vs the JAX |x|^2+|y|^2-2xy expansion,
    # which loses ~1e-6 absolute at |x|^2 ~ 27
    close(tknn.mean_dist2_knn3(torch.tensor(pts)),
          jknn.mean_dist2_knn3(jnp.asarray(pts)), atol=1e-5, rtol=1e-4)
    for kw in ({}, {"fixed_scale": 0.05, "init_opacity": 0.8},
               {"fourier_dim": 3}):
        jp = jparams.init_pool_from_points(pts, cols, capacity=512, **kw)
        tp = tparams.init_pool_from_points(pts, cols, capacity=512, **kw)
        for f in tparams.FIELDS:
            # log-scales inherit the knn difference above: log(d2)/2
            atol = 1e-4 if f == "scaling" else ATOL
            close(getattr(tp, f), getattr(jp, f), atol=atol)
    # capacity below the point count subsamples with default_rng(0)
    jp = jparams.init_pool_from_points(pts, cols, capacity=100)
    tp = tparams.init_pool_from_points(pts, cols, capacity=100)
    close(tp.xyz, jp.xyz)
    e_j, e_t = jparams.empty_pool(8, 2, 2), tparams.empty_pool(8, 2, 2)
    for f in tparams.FIELDS:
        close(getattr(e_t, f), getattr(e_j, f))


def pool_arrays(rng, n, fourier=1, lead=()):
    shape = lead + (n,)
    return {
        "xyz": rng.normal(size=shape + (3,)).astype(np.float32),
        "features_dc": rng.normal(size=shape + (fourier, 3)).astype(np.float32),
        "features_rest": rng.normal(size=shape + (8, 3)).astype(np.float32),
        "scaling": rng.normal(-2, 0.5, shape + (3,)).astype(np.float32),
        "rotation": rng.normal(size=shape + (4,)).astype(np.float32),
        "opacity": rng.normal(size=shape + (1,)).astype(np.float32),
        "valid": rng.random(shape) > 0.2,
    }


def scene_arrays(rng, C=2, F=5, A=3):
    quats = rng.normal(size=(C, F, A, 4)).astype(np.float32)
    params = {
        "bkgd": pool_arrays(rng, 40),
        "actors": pool_arrays(rng, 16, fourier=3, lead=(A,)),
        "sky": {**pool_arrays(rng, 20),
                "xyz": rng.normal(size=(20, 3)).astype(np.float32) * 30},
        "opt_trans": rng.normal(0, 0.1, (C, F, A, 3)).astype(np.float32),
        "opt_theta": rng.normal(0, 0.1, (C, F, A, 1)).astype(np.float32),
        "sky_cubemap": None, "color_corr": None, "color_corr_sky": None,
        "pose_corr_quat": None, "pose_corr_trans": None,
        "color_mlp": None, "color_mlp_sky": None,
    }
    valid = rng.random((C, F, A)) > 0.2
    valid[:, 1:4, 0] = True            # actor 0 interpolates at frame 2
    meta = {
        "track_trans": rng.normal(0, 3, (C, F, A, 3)).astype(np.float32),
        "track_quats": quats / np.linalg.norm(quats, axis=-1, keepdims=True),
        "track_valid": valid,
        "timestamps": np.cumsum(rng.uniform(0.05, 0.15, (C, F)),
                                1).astype(np.float32),
        "actor_frame_range": np.array([[0, 4], [1, 3], [2, 2]], np.float32),
        "actor_bbox": np.ones((A, 3), np.float32),
        "actor_random_init": np.zeros(A, bool),
        "sphere_center": np.array([0.5, 0.0, 1.0], np.float32),
        "sphere_radius": np.float32(12.0),
        "fourier_scale": 1.5,
    }
    return params, meta


@pytest.mark.parametrize("frame_idx,interpolate", [(2, True), (0, True),
                                                   (3, False)])
def test_flatten_scene_posed_actors(rng, frame_idx, interpolate):
    params, meta = scene_arrays(rng)
    jp, jm = jax_scene_from_numpy(params, meta)
    # the JAX-built scene goes through the test-side flattening, like the
    # render test does
    tp, tm = scene_from_numpy(jax_tree_to_numpy(jp), jax_tree_to_numpy(jm))
    flip = rng.random((3, 16)) > 0.5
    ts = float(meta["timestamps"][1, frame_idx]) + 0.02
    jf = jscene.flatten_scene(jp, jm, jnp.int32(1), jnp.int32(frame_idx),
                              jnp.float32(frame_idx + 0.25),
                              jnp.float32(ts), interpolate=interpolate,
                              flip_mask=jnp.asarray(flip))
    tf = tscene.flatten_scene(tp, tm, 1, frame_idx, frame_idx + 0.25, ts,
                              interpolate=interpolate,
                              flip_mask=torch.tensor(flip))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    for name in ("xyz", "rotation", "scaling", "opacity", "shs"):
        # sky points are pinned onto a 24-unit sphere: f32 spacing ~2e-6
        close(getattr(tf, name), getattr(jf, name), atol=2e-5)
    qj, tj, vj = jscene.actor_pose(jp, jm, jnp.int32(1),
                                   jnp.int32(frame_idx), jnp.float32(ts),
                                   interpolate)
    qt, tt, vt = tscene.actor_pose(tp, tm, 1, frame_idx, ts, interpolate)
    close(qt, qj)
    close(tt, tj)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_sky_pin_and_actor_time(rng):
    params, meta = scene_arrays(rng)
    jp, jm = jax_scene_from_numpy(params, meta)
    tp, tm = scene_from_numpy(params, meta)
    xyz, sc = params["sky"]["xyz"], np.exp(params["sky"]["scaling"]) * 50
    jx, js = jscene.sky_pin(jnp.asarray(xyz), jnp.asarray(sc), jm)
    tx, ts = tscene.sky_pin(torch.tensor(xyz), torch.tensor(sc), tm)
    close(tx, jx, atol=2e-5)
    close(ts, js)
    close(tscene.actor_time(tm, torch.tensor(2.5)),
          jscene.actor_time(jm, jnp.float32(2.5)))
    nometa = dataclasses.replace(tm, sphere_center=None)
    assert tscene.sky_pin(tx, ts, nometa)[0] is tx

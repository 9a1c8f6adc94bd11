"""Port parity: ops/maths, ops/quaternion, ops/sh and datasets/cameras of
street_crafter_tpu_torch against the JAX package on the same numpy inputs.

Tolerance: atol 1e-5 throughout. Both sides compute in float32 on the CPU
with the same formulas; what differs is the order of a few sums inside
library calls (einsum, norm, matmul), worth a few ulp at these magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.datasets.cameras import Camera as JCamera
from street_crafter_tpu.ops import maths as jm
from street_crafter_tpu.ops import quaternion as jq
from street_crafter_tpu.ops import sh as jsh
from street_crafter_tpu_torch.datasets.cameras import Camera as TCamera
from street_crafter_tpu_torch.ops import maths as tm
from street_crafter_tpu_torch.ops import quaternion as tq
from street_crafter_tpu_torch.ops import sh as tsh

ATOL = 1e-5


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor)
                               else np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


def quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def rigid(rng):
    q = rng.normal(size=4)
    R = np.asarray(jq.to_matrix(jnp.asarray(q, jnp.float32)))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R
    m[:3, 3] = rng.uniform(-3, 3, 3)
    return m


K_NP = np.array([[50.0, 0.3, 31.0], [0.0, 48.0, 22.5], [0, 0, 1]], np.float32)


def test_world_to_view_projection_inverse(rng):
    m = rigid(rng)
    R, T = m[:3, :3], m[:3, 3]
    close(tm.world_to_view(torch.tensor(R), torch.tensor(T)),
          jm.world_to_view(jnp.asarray(R), jnp.asarray(T)))
    close(tm.projection_from_K(torch.tensor(K_NP), 48, 64, 0.05, 80.0),
          jm.projection_from_K(jnp.asarray(K_NP), 48, 64, 0.05, 80.0))
    close(tm.affine_inverse(torch.tensor(m)), jm.affine_inverse(jnp.asarray(m)))
    assert tm.fov_from_K(K_NP, 48, 64) == jm.fov_from_K(K_NP, 48, 64)


def test_points_rays_sphere(rng):
    m = rigid(rng)
    pts = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    pts[:, 2] += 8
    close(tm.transform_points(torch.tensor(m), torch.tensor(pts)),
          jm.transform_points(jnp.asarray(m), jnp.asarray(pts)))
    uv_t, d_t = tm.project_points(torch.tensor(K_NP), torch.tensor(m),
                                  torch.tensor(pts))
    uv_j, d_j = jm.project_points(jnp.asarray(K_NP), jnp.asarray(m),
                                  jnp.asarray(pts))
    close(d_t, d_j)
    # pixel coordinates reach ~1e3: f32 spacing there is ~6e-5
    close(uv_t, uv_j, atol=2e-4)
    o_t, r_t = tm.get_rays(torch.tensor(K_NP), torch.tensor(m), 6, 8)
    o_j, r_j = jm.get_rays(jnp.asarray(K_NP), jnp.asarray(m), 6, 8)
    close(o_t, o_j)
    close(r_t, r_j)
    c = np.array([0.5, -0.2, 0.1], np.float32)
    close(tm.ray_sphere_intersection(o_t, r_t, torch.tensor(c), 30.0),
          jm.ray_sphere_intersection(o_j, r_j, jnp.asarray(c), 30.0),
          atol=1e-4)   # distances ~30: a few f32 ulp


def test_expon_lr():
    for step in (0, 10, 500, 30000):
        assert tm.expon_lr(step, 1.6e-4, 1.6e-6, 100, 0.01, 30000) == \
            pytest.approx(float(jm.expon_lr(step, 1.6e-4, 1.6e-6, 100, 0.01,
                                            30000)), rel=1e-5)


def test_quaternion_algebra(rng):
    a, b = quats(rng, 64), quats(rng, 64)
    close(tq.normalize(torch.tensor(a)), jq.normalize(jnp.asarray(a)))
    close(tq.to_matrix(torch.tensor(a)), jq.to_matrix(jnp.asarray(a)))
    close(tq.multiply(torch.tensor(a), torch.tensor(b)),
          jq.multiply(jnp.asarray(a), jnp.asarray(b)))
    close(tq.invert(torch.tensor(a)), jq.invert(jnp.asarray(a)))
    mats = np.asarray(jq.to_matrix(jnp.asarray(a)))
    close(tq.from_matrix(torch.tensor(mats)), jq.from_matrix(jnp.asarray(mats)))
    u = tq.normalize(torch.tensor(a))
    v = rng.normal(size=(64, 3)).astype(np.float32)
    close(tq.rotate(u, torch.tensor(v)), jq.rotate(jnp.asarray(u.numpy()),
                                                   jnp.asarray(v)))
    # broadcast [A,1,4] x [A,cap,3], the actor-posing shape
    vv = rng.normal(size=(4, 5, 3)).astype(np.float32)
    close(tq.rotate(u[:4, None], torch.tensor(vv)),
          jq.rotate(jnp.asarray(u.numpy()[:4, None]), jnp.asarray(vv)))
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[:3] *= 1e-8                     # the small-angle branch
    close(tq.from_axis_angle(torch.tensor(aa)),
          jq.from_axis_angle(jnp.asarray(aa)))
    close(tq.to_axis_angle(torch.tensor(a)), jq.to_axis_angle(jnp.asarray(a)))


def test_slerp(rng):
    q0, q1 = quats(rng, 32), quats(rng, 32)
    q1[:4] = q0[:4]                    # theta = 0: the lerp branch
    q1[4:8] = -q0[4:8]                 # antipodal: the sign flip
    t = rng.uniform(0, 1, 32).astype(np.float32)
    close(tq.slerp(torch.tensor(q0), torch.tensor(q1), torch.tensor(t)),
          jq.slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))
    close(tq.slerp(torch.tensor(q0), torch.tensor(q1), 0.3),
          jq.slerp(jnp.asarray(q0), jnp.asarray(q1), 0.3))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(rng, deg):
    k = (deg + 1) ** 2
    sh = rng.normal(size=(40, 3, k + 2)).astype(np.float32)
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    close(tsh.eval_sh(deg, torch.tensor(sh), torch.tensor(dirs)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))


def test_sh_conversions_and_idft(rng):
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(torch.tensor(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    close(tsh.sh_to_rgb(torch.tensor(rgb)), jsh.sh_to_rgb(jnp.asarray(rgb)))
    t = rng.uniform(-1, 2, 7).astype(np.float32)
    for dim in (1, 4, 5):
        close(tsh.idft_basis(torch.tensor(t), dim),
              jsh.idft_basis(jnp.asarray(t), dim))
    close(tsh.idft_basis(0.37, 5), jsh.idft_basis(0.37, 5))


def test_camera(rng):
    w2c = rigid(rng)
    jc = JCamera.from_extrinsic(w2c, K_NP, 64, 48)
    tc = TCamera.from_extrinsic(w2c, K_NP, 64, 48)
    for name in ("R", "T", "K", "w2c", "c2w", "camera_center",
                 "projection_matrix", "full_proj_transform"):
        close(getattr(tc, name), getattr(jc, name))
    assert tc.fov == jc.fov
    c2w = np.linalg.inv(w2c.astype(np.float64))
    close(TCamera.from_c2w(c2w, K_NP, 64, 48).w2c,
          JCamera.from_c2w(c2w, K_NP, 64, 48).w2c)
    # rescale rounds the size (1920x1280 / 1.2 -> 1600x1067)
    jr = JCamera.from_extrinsic(w2c, K_NP, 1920, 1280).rescale(1 / 1.2)
    tr = TCamera.from_extrinsic(w2c, K_NP, 1920, 1280).rescale(1 / 1.2)
    assert (tr.width, tr.height) == (jr.width, jr.height) == (1600, 1067)
    close(tr.K, jr.K)
    np.testing.assert_allclose(tc.get_extrinsic(), jc.get_extrinsic(),
                               atol=ATOL)

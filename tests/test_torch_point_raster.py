"""The port's point raster (street_crafter_tpu_torch.ops.point_raster)
against the JAX package's, on the CPU.

- ``splat_points`` / ``render_pointcloud`` (the z-buffer of hard disks) on
  the inputs of tests/test_point_raster.py and on a street cloud: equal to
  JAX's, bit for bit (the same sort, rank cap, window order and ties).
- ``render_pointcloud_gaussian`` (the condition render) on
  tests/test_condition_parity.py's street cloud at lane shifts 0 and 3 m,
  held against JAX's render through its exact XLA raster without
  capacities, and against JAX's ``render_pointcloud_gaussian`` itself on
  the tiles where its 512-a-tile cap cannot bind. Tolerances: rgb and acc
  1e-3, depth 1e-3 of the largest depth, where the port's stop rule cannot
  act (final T > 0.1); elsewhere T more (rgb, acc) or T / (1 - T) of the
  largest depth more (depth). The port stops a pixel before the splat
  that would take T to <= 1e-4 (gsplat's rule) and JAX composites the
  whole list; the tail JAX adds weighs at most T at the stop, which at
  opacity 1 (alpha 0.999) reaches 1e-4 / (1 - 0.999) = 0.1.
- The same cloud against tests/torch_ref/point_raster_torch.py (an
  independent transcription of the reference's rasterizer): PSNR >= 40 dB.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from street_crafter_tpu.ops import point_raster as J
from street_crafter_tpu.ops.gs_raster import rasterize_pixels as j_raster
from street_crafter_tpu_torch.ops import gs_raster as G
from street_crafter_tpu_torch.ops import point_raster as P
from tests.test_condition_parity import make_street_points, psnr
from tests.torch_ref.point_raster_torch import render_pointcloud_torch

TOL = 1e-3
JAX_TILE_CAP = 512    # JAX render_pointcloud_gaussian's max_per_tile


def t(a):
    return torch.tensor(np.asarray(a))


def assert_equal(port, jax_out):
    for name, a, b in zip(P.PointRenderOutput._fields, port, jax_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def small_scene(seed, n):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(0.5, 5.0, n)], -1).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    radii = rng.uniform(0.5, 3.0, n).astype(np.float32)
    return pts, cols, radii


@pytest.mark.parametrize("seed,n,layers", [(0, 40, 4), (1, 400, 4),
                                           (2, 400, 2)])
def test_splat_points_equals_jax(seed, n, layers):
    """tests/test_point_raster.py's small scene, and denser ones where the
    per-pixel layer cap binds (a point ranked past it is dropped)."""
    H, W = 24, 32
    K = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]], np.float32)
    pts, cols, radii = small_scene(seed, n)
    mask = np.random.default_rng(seed + 10).random(n) > 0.1
    want = J.splat_points(jnp.asarray(pts), jnp.asarray(cols),
                          jnp.asarray(radii), jnp.asarray(K), H, W,
                          mask=jnp.asarray(mask), max_radius_px=4,
                          layers=layers)
    got = P.splat_points(t(pts), t(cols), t(radii), t(K), H, W,
                         mask=t(mask), max_radius_px=4, layers=layers)
    assert_equal(got, want)
    assert float(got.acc.mean()) > 0.2


def test_splat_points_edge_cases():
    """test_point_raster.py's nearest-wins, mask and behind-camera cases."""
    K = np.array([[16.0, 0, 8], [0, 16.0, 8], [0, 0, 1]], np.float32)
    pts = np.array([[0, 0, 2.0], [0, 0, 1.0], [0, 0, -1.0]], np.float32)
    cols = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    radii = np.array([2.0, 2.0, 2.0], np.float32)
    for mask in (None, np.array([True, False, True])):
        want = J.splat_points(jnp.asarray(pts), jnp.asarray(cols),
                              jnp.asarray(radii), jnp.asarray(K), 16, 16,
                              mask=None if mask is None else
                              jnp.asarray(mask), max_radius_px=3)
        got = P.splat_points(t(pts), t(cols), t(radii), t(K), 16, 16,
                             mask=None if mask is None else t(mask),
                             max_radius_px=3)
        assert_equal(got, want)
        winner = [0, 1, 0] if mask is None else [1, 0, 0]
        np.testing.assert_array_equal(got.rgb[8, 8].numpy(), winner)


@pytest.mark.parametrize("shift,ndc", [(0.0, True), (3.0, True),
                                       (0.0, False)])
def test_render_pointcloud_equals_jax(shift, ndc):
    pts, cols = make_street_points(np.random.default_rng(0))
    H, W = 96, 160
    K = np.array([[110.0, 0, W / 2], [0, 110.0, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3] = shift
    kw = dict(scale=0.01 if ndc else 0.05, use_ndc_scale=ndc)
    want = J.render_pointcloud(jnp.asarray(c2w), jnp.asarray(K),
                               jnp.asarray(pts), jnp.asarray(cols), H, W,
                               **kw)
    got = P.render_pointcloud(t(c2w), t(K), t(pts), t(cols), H, W, **kw)
    assert_equal(got, want)
    assert float(got.acc.mean()) > 0.03   # the cloud covers pixels


def jax_gaussian_uncapped(c2w, K, points, colors, H, W, scale=0.01,
                          use_ndc_scale=True, mask=None, occ=1.0):
    """JAX's render_pointcloud_gaussian (ndc scale) through its exact XLA
    raster with capacities of the whole cloud: the same function without
    drops. Returns numpy (rgb, acc, depth)."""
    from street_crafter_tpu.ops import maths
    assert use_ndc_scale
    K = jnp.asarray(K)
    pc = maths.transform_points(maths.affine_inverse(jnp.asarray(c2w)),
                                jnp.asarray(points))
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = jnp.maximum(z, 1e-6)
    u, v = K[0, 0] * x / zs + K[0, 2], K[1, 1] * y / zs + K[1, 2]
    valid = z > 0.2
    if mask is not None:
        valid = valid & jnp.asarray(mask)
    n = len(points)
    sigma = J.ndc_radius_px(scale, H, W)
    inv = jnp.full(n, 1.0 / (sigma * sigma), jnp.float32)
    chan = jnp.concatenate([jnp.asarray(colors, jnp.float32), z[:, None]],
                           -1)
    out = j_raster(u, v, inv, jnp.zeros(n), inv, chan, jnp.full(n, occ),
                   z, valid, jnp.full(n, 3.0 * sigma), width=W, height=H,
                   tile_size=16, max_per_tile=n, coarse_factor=8,
                   max_per_coarse=n, exact_select=True)
    acc = np.asarray(out.alpha)
    c = np.asarray(out.colors)
    depth = np.where(acc > 0, c[..., 3] / np.maximum(acc, 1e-10), 0.0)
    return c[..., :3], acc, depth


def check_stop_rule_bounds(port, rgb, acc, depth, zmax, where):
    """The module docstring's tolerances over the pixels ``where``."""
    T = 1.0 - port.acc.numpy()
    free = T > 0.1
    slack = np.where(free, 0.0, T)
    d_rgb = np.abs(port.rgb.numpy() - rgb).max(-1)
    d_acc = np.abs(port.acc.numpy() - acc)
    d_depth = np.abs(port.depth.numpy() - depth) / zmax
    slack_depth = np.where(free, 0.0, T / np.maximum(1.0 - T, 1e-6))
    for name, d, s in (("rgb", d_rgb, slack), ("acc", d_acc, slack),
                       ("depth", d_depth, slack_depth)):
        excess = (d - s - TOL)[where]
        assert excess.max() <= 0, (name, float(excess.max()))
    # the stop rule needs a near-opaque pixel; elsewhere the two agree
    assert d_rgb[where & free].max() <= TOL
    return d_rgb[where]


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_gaussian_matches_jax(shift):
    pts, cols = make_street_points(np.random.default_rng(0))
    H, W = 96, 160
    K = np.array([[110.0, 0, W / 2], [0, 110.0, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3] = shift
    got = P.render_pointcloud_gaussian(t(c2w), t(K), t(pts), t(cols), H, W,
                                       occ=1.0)
    # the port's tile lists (the exact worklist of its raster)
    a = P.gaussian_splats(t(c2w), t(K), t(pts), t(cols), H, W)
    wl = G.tile_worklist_reference(a["u"], a["v"], a["radii"], a["depths"],
                                   a["valid"], W, H)
    lengths = (wl.ranges[:, 1] - wl.ranges[:, 0]).numpy()
    zmax = float(a["depths"][a["valid"]].max())

    full = jax_gaussian_uncapped(c2w, K, pts, cols, H, W)
    everywhere = np.ones((H, W), bool)
    d = check_stop_rule_bounds(got, *full, zmax, everywhere)
    assert (d <= TOL).mean() > 0.99
    print(f"shift {shift}: rgb max {d.max():.3g}, share within {TOL} "
          f"{(d <= TOL).mean():.4f}; longest list {lengths.max()}, pairs "
          f"past {JAX_TILE_CAP} {np.clip(lengths - JAX_TILE_CAP, 0, None).sum()}")

    capped = J.render_pointcloud_gaussian(
        jnp.asarray(c2w), jnp.asarray(K), jnp.asarray(pts),
        jnp.asarray(cols), H, W, scale=0.01, use_ndc_scale=True, occ=1.0,
        select_method="exact")
    tw, th = G.tile_grid(W, H)
    short = np.kron((lengths <= JAX_TILE_CAP).reshape(th, tw),
                    np.ones((16, 16), bool))[:H, :W]
    check_stop_rule_bounds(got, *(np.asarray(a) for a in capped), zmax,
                           short)
    # shift 0 has a tile past the cap (JAX keeps its 512 nearest), shift 3
    # none: then JAX's own render drops nothing at all
    assert (lengths.max() > JAX_TILE_CAP) == (shift == 0.0)


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_gaussian_vs_torch_reference(shift):
    pts, cols = make_street_points(np.random.default_rng(0))
    H, W = 96, 160
    K = np.array([[110.0, 0, W / 2], [0, 110.0, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3] = shift
    got = P.render_pointcloud_gaussian(t(c2w), t(K), t(pts), t(cols), H, W)
    ref_rgb, ref_acc = render_pointcloud_torch(c2w, K, pts, cols, H, W,
                                               scale=0.01, occ=1.0)
    assert psnr(got.rgb.numpy(), ref_rgb) >= 40.0
    assert psnr(got.acc.numpy(), ref_acc) >= 40.0
    assert ref_acc.max() > 0.9


def test_gaussian_counts_plain_launches():
    """On CPU tensors the condition render runs the plain worklist and
    composite, once each, with the 4 channels rgb and z."""
    pts, cols = make_street_points(np.random.default_rng(1), n=300)
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]], np.float32)
    G.reset_launch_counts()
    out = P.render_pointcloud_gaussian(t(np.eye(4, dtype=np.float32)), t(K),
                                       t(pts), t(cols), 48, 64)
    assert dict(G.launches) == {"tile_worklist_reference": 1,
                                "composite_reference": 1}
    assert out.rgb.shape == (48, 64, 3) and out.depth.shape == (48, 64)

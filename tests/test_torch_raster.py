"""Port parity: the raster of street_crafter_tpu_torch (plain torch versions,
the path CPU tensors take) against the JAX package's rasterizers, and its
tile worklist against a brute-force per-tile list."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.ops.gs_raster import rasterize_pixels as j_raster
from street_crafter_tpu.ops.gs_raster_fused import rasterize_pixels_fused
from street_crafter_tpu_torch.ops import gs_raster as G


def splats(n, W, H, seed, opa_range=(0.2, 0.9), wide=0.0):
    """Projected splats as the raster takes them; ``wide`` of them get
    radii of 30..100 px, far wider than a 16-px tile."""
    rng = np.random.default_rng(seed)
    sc = rng.uniform(1.0, 6.0, n).astype(np.float32)
    k = int(wide * n)
    sc[:k] = rng.uniform(10.0, 33.0, k)
    ca = 1.0 / sc ** 2
    cc = 1.0 / (sc * 0.8) ** 2
    cb = 0.3 * np.sqrt(ca * cc) * rng.uniform(-1, 1, n)
    depth = rng.uniform(1, 50, n).astype(np.float32)
    cols = np.concatenate([rng.uniform(size=(n, 3)), depth[:, None]], 1)
    valid = rng.random(n) > 0.1
    return [x.astype(np.float32) if x.dtype != bool else x for x in (
        rng.uniform(-20, W + 20, n), rng.uniform(-20, H + 20, n), ca, cb,
        cc, cols, rng.uniform(*opa_range, n), depth, valid,
        np.ceil(3 * sc) * valid)]


def port(args, W, H):
    return G.rasterize_pixels(*[torch.tensor(a) for a in args], width=W,
                              height=H)


@pytest.mark.parametrize("seed,wide", [(0, 0.0), (1, 0.05), (2, 0.2)])
def test_raster_matches_jax_exact(seed, wide):
    W, H, n = 64, 48, 400
    args = splats(n, W, H, seed, wide=wide)
    ref = j_raster(*[jnp.asarray(a) for a in args], width=W, height=H,
                   tile_size=16, max_per_tile=n, coarse_factor=8,
                   max_per_coarse=n, exact_select=True)
    out = port(args, W, H)
    rc, ra = np.asarray(ref.colors), np.asarray(ref.alpha)
    # JAX composites every splat; the port stops before the splat that
    # would take T to <= 1e-4 and drops the tail. The difference is at most
    # T at the stop <= 1e-4 / (1 - max alpha) = 1e-3 for opacity <= 0.9,
    # times the channel's magnitude
    np.testing.assert_allclose(out.colors[..., :3].numpy(), rc[..., :3],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(out.alpha.numpy(), ra, atol=1e-3, rtol=0)
    max_depth = float(args[7][args[8]].max())
    np.testing.assert_allclose(out.colors[..., 3].numpy(), rc[..., 3],
                               atol=1e-3 * max_depth, rtol=0)
    assert out.n_pairs == G.tile_worklist_reference(
        *[torch.tensor(args[i]) for i in (0, 1, 9, 7, 8)], W, H).n_pairs


@pytest.mark.parametrize("seed", [3, 4])
def test_raster_matches_jax_fused(seed):
    W, H, n = 128, 64, 600
    args = splats(n, W, H, seed, wide=0.05)
    ref = rasterize_pixels_fused(*[jnp.asarray(a) for a in args], width=W,
                                 height=H, tile_size=16, coarse_factor=8,
                                 max_per_coarse=n, max_per_row=n,
                                 select_method="exact")
    out = port(args, W, H)
    rgb = out.colors[..., :3].numpy()
    mse = float(np.mean((rgb - np.asarray(ref.colors)[..., :3]) ** 2))
    # the bounds of tests/test_gs_raster_fused.py: the fused kernel bins in
    # 16x128 strips and stops a whole row once it is below 1/255
    assert -10 * np.log10(mse + 1e-12) > 50.0
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha),
                               atol=1e-2, rtol=0)


def brute_force_lists(u, v, radii, depths, valid, W, H):
    tw, th = G.tile_grid(W, H)
    lists = []
    for ty in range(th):
        for tx in range(tw):
            x0, y0 = tx * 16, ty * 16
            hit = [i for i in range(len(u))
                   if valid[i] and radii[i] > 0
                   and u[i] - radii[i] < x0 + 16 and u[i] + radii[i] > x0
                   and v[i] - radii[i] < y0 + 16 and v[i] + radii[i] > y0]
            lists.append(sorted(hit, key=lambda i: (depths[i], i)))
    return lists


@pytest.mark.parametrize("seed", [5, 6])
def test_worklist_equals_brute_force(seed):
    W, H, n = 96, 56, 150
    u, v, _, _, _, _, _, depths, valid, radii = splats(n, W, H, seed,
                                                       wide=0.3)
    radii[:3] = [0.0, 200.0, 1e6]      # culled, wider than the image, huge
    valid[:3] = True
    depths[10:14] = depths[14]         # depth ties resolve by splat id
    lists = brute_force_lists(u, v, radii, depths, valid, W, H)
    wl = G.tile_worklist_reference(
        *[torch.tensor(a) for a in (u, v, radii, depths, valid)], W, H)
    assert wl.n_pairs == sum(map(len, lists))
    assert sum(len(x) for x in lists if len(x) > 20) > 0   # wide splats hit
    for t, ids in enumerate(lists):
        s, e = wl.ranges[t].tolist()
        assert wl.gauss_ids[s:e].tolist() == ids, t
        assert (wl.tile_ids[s:e] == t).all()
        if not ids:
            assert (s, e) == (0, 0)


def test_raster_routing_and_counts():
    W, H = 32, 32
    args = [torch.tensor(a) for a in splats(50, W, H, 7)]
    G.reset_launch_counts()
    out = G.rasterize_pixels(*args, width=W, height=H)
    assert out.colors.shape == (H, W, 4) and out.alpha.shape == (H, W)
    # CPU tensors take the plain versions, never the kernels
    assert dict(G.launches) == {"tile_worklist_reference": 1,
                                "composite_reference": 1}
    with pytest.raises(ValueError, match="tile_size"):
        G.rasterize_pixels(*args, width=W, height=H, tile_size=8)
    wide = list(args)
    wide[5] = torch.zeros(50, 8)
    with pytest.raises(ValueError, match="channels"):
        G.rasterize_pixels(*wide, width=W, height=H)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cpu and cuda"):
        G.rasterize_pixels(*meta, width=W, height=H)
    mixed = list(args)
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(ValueError, match="tensors on"):
        G.rasterize_pixels(*mixed, width=W, height=H)

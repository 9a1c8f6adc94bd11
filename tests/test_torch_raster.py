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
from raster_cases import adversarial_cull_splats  # tests/raster_cases.py


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
    wide[5] = torch.zeros(50, G.MAX_CHANNELS + 1)   # past the kernels' 32
    with pytest.raises(ValueError, match="channels"):
        G.rasterize_pixels(*wide, width=W, height=H)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cpu and cuda"):
        G.rasterize_pixels(*meta, width=W, height=H)
    mixed = list(args)
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(ValueError, match="tensors on"):
        G.rasterize_pixels(*mixed, width=W, height=H)


def cull_inputs(kind, seed, wide):
    """(tensors, W, H) of the raster: the JAX-parity splats of this file,
    or the adversarial set of tests/raster_cases.py."""
    if kind == "adversarial":
        W, H = 64, 48
        d = adversarial_cull_splats(W, H, seed)
        return {k: torch.tensor(x) for k, x in d.items()}, W, H
    W, H, n = 64, 48, 400
    names = ("u", "v", "conic_a", "conic_b", "conic_c", "colors",
             "opacities", "depths", "valid", "radii")
    return ({k: torch.tensor(x) for k, x in
             zip(names, splats(n, W, H, seed, wide=wide))}, W, H)


@pytest.mark.parametrize("kind,seed,wide",
                         [("jax", s, w) for s in (0, 1)
                          for w in (0.0, 0.05, 0.2)]
                         + [("adversarial", s, None) for s in (0, 1, 2)])
def test_warp_cull_is_conservative(kind, seed, wide):
    """The per-warp cull of kernels B and C (its plain version) removes
    only pairs that every pixel of the warp skips: the plain compositing
    with the culled pairs forced to alpha 0 is bit-equal to the plain
    compositing, and so is every (pair, pixel) alpha of the tiles."""
    t, W, H = cull_inputs(kind, seed, wide)
    wl = G.tile_worklist_reference(t["u"], t["v"], t["radii"], t["depths"],
                                   t["valid"], W, H)
    comp = [t[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                           "colors", "opacities")]
    geo = comp[:5] + [t["opacities"]]
    cull = G.warp_cull_reference(wl, *geo, W)
    assert cull.shape == (wl.n_pairs, G.WARPS) and cull.dtype == torch.bool
    plain = G.composite_reference(wl, *comp, W, H, train=True)
    culled = G.composite_reference(wl, *comp, W, H, train=True, cull=cull)
    for name, a, b in zip(("colors", "alpha", "T", "last"), plain, culled):
        assert torch.equal(a, b), name
    start = 0
    for ts in G._tiles(wl, *geo, W):
        k = ts.g.shape[0]
        hit = cull[start:start + k].repeat_interleave(32, 1) & (ts.alpha > 0)
        assert not bool(hit.any())
        start += k
    # the cull removes a share of the pairs, not all of them
    share = float(cull.float().mean())
    assert 0.05 < share < 0.95, share


_SIZES = {1: 32, 2: 48, 3: 48, 4: 48, 5: 48, 6: 64, 7: 64}


@pytest.mark.parametrize("C", range(1, 8))
def test_pair_records_layout(C):
    """One record per (tile, splat) pair in list order: u, v, a, b, c,
    opacity, the cull threshold, the C channels, zeros to a multiple of 16
    bytes (what the kernels' bulk copies need)."""
    W, H, n = 48, 32, 120
    args = splats(n, W, H, C, wide=0.1)
    t = [torch.tensor(a) for a in args]
    rng = np.random.default_rng(C)
    colors = torch.tensor(rng.uniform(0, 1, (n, C)), dtype=torch.float32)
    opa = t[6].clone()
    opa[:4] = torch.tensor([0.001, 0.0039, 1 / 255, 0.5])
    cb = t[3].clone()
    cb[4] = 2 * torch.sqrt(t[2][4] * t[4][4])       # not positive definite
    wl = G.tile_worklist_reference(t[0], t[1], t[9], t[7], t[8], W, H)
    assert wl.n_pairs > 0
    rec = G.pair_records(wl, t[0], t[1], t[2], cb, t[4], colors, opa)
    rs = G.record_floats(C)
    assert 4 * rs == _SIZES[C] and (4 * rs) % 16 == 0
    assert rec.shape == (wl.n_pairs, rs) and rec.dtype == torch.float32
    assert rec.is_contiguous()
    g = wl.gauss_ids.to(torch.int64)
    for col, x in ((G.REC_U, t[0]), (G.REC_V, t[1]), (G.REC_A, t[2]),
                   (G.REC_B, cb), (G.REC_C, t[4]), (G.REC_OPACITY, opa)):
        assert torch.equal(rec[:, col], x[g]), col
    assert torch.equal(rec[:, G.REC_COLORS:G.REC_COLORS + C], colors[g])
    assert not bool(rec[:, G.REC_COLORS + C:].any())
    thr = rec[:, G.REC_THRESHOLD]
    o, a, c = opa[g], t[2][g], t[4][g]
    assert bool((thr[o < G.ALPHA_MIN] == float("-inf")).all())
    pd = (a > 0) & (a * c - cb[g] ** 2 > 0) & (o >= G.ALPHA_MIN)
    assert bool((thr[(o >= G.ALPHA_MIN) & ~pd] == float("inf")).all())
    torch.testing.assert_close(thr[pd], torch.log(255 * o[pd]) + 1e-5,
                               atol=0, rtol=0)
    assert bool((g == 4).any()) and bool((o < G.ALPHA_MIN).any())

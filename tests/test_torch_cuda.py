"""The CUDA kernels of street_crafter_tpu_torch (raster A-C, also at the
LiDAR condition render's shape and in a GS step with the cubemap sky and
the colour MLPs, and kernel A's row-compaction variants, attention D,
its backward G and H in bf16 and in f32, temporal stage E and F and the
GEMM they chain)
against their plain torch versions on a CUDA device. Marked ``cuda``; each
test skips when no CUDA device is present. On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: the worklist (with its tile order) must be equal; compositing
with records shared from the forward must equal compositing that packs its
own; compositing agrees to atol 2e-4 on
rgb and alpha (both decide the 1/255 and 1e-4 thresholds on identically
rounded values; only the colour sums run in another order); the backward
(kernel C) agrees per field to 1e-4 (GRAD_RTOL below) of the field's
largest gradient, of its norm and, in the median over splats, of each
splat's own gradient.
"""

import numpy as np
import pytest
import torch

from street_crafter_tpu_torch.ops import gs_raster as G
from street_crafter_tpu_torch.ops import row_compact as RC
from street_crafter_tpu_torch.scripts import bench_phase1_variants as PV
from raster_cases import adversarial_cull_splats  # tests/raster_cases.py
from row_compact_cases import CASES, chunk_case  # tests/row_compact_cases.py

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def splat_args(device, n, W, H, seed, wide, channels=4):
    """Random projected splats; ``channels`` 4 is rgb + depth (the main
    path's), any other count channels in [0, 1]."""
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(1.0, 8.0, n)
    k = int(wide * n)
    sigma[:k] = rng.uniform(30.0, 100.0, k)
    ca = 1.0 / sigma ** 2
    cc = 1.0 / (0.7 * sigma) ** 2
    depth = rng.uniform(1.0, 80.0, n)
    valid = rng.random(n) > 0.05

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    colors = (np.concatenate([rng.random((n, 3)), depth[:, None]], 1)
              if channels == 4 else rng.random((n, channels)))
    return dict(u=t(rng.uniform(-40, W + 40, n)),
                v=t(rng.uniform(-40, H + 40, n)), conic_a=t(ca),
                conic_b=t(0.3 * np.sqrt(ca * cc) * rng.uniform(-1, 1, n)),
                conic_c=t(cc), colors=t(colors),
                opacities=t(rng.uniform(0.02, 1.0, n)), depths=t(depth),
                valid=t(valid, torch.bool),
                radii=t(np.ceil(3 * sigma) * valid), width=W, height=H)


# channel counts: 4 is the main path's (rgb + depth); 1, 3, 7 the record
# sizes 32, 48 and 64 bytes at the edges of the kernels' templates
CHANNELS = (1, 3, 4, 7)


def rgb_channels(C):
    """The channels held to the colour limit: all but the depth of C = 4."""
    return 3 if C == 4 else C


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("seed,wide", [(0, 0.0), (1, 0.1)])
def test_kernels_match_plain_versions(cuda, seed, wide, C):
    args = splat_args(cuda, 20_000, 200, 136, seed, wide, C)
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    G.reset_launch_counts()
    wl = G.tile_worklist(**geo)
    ref = G.tile_worklist_reference(**geo)
    assert wl.n_pairs == ref.n_pairs > 0
    for name in ("tile_ids", "gauss_ids", "ranges", "order"):
        assert torch.equal(getattr(wl, name), getattr(ref, name)), name
    col, alpha = G.composite(wl, **comp)
    col_ref, alpha_ref = G.composite_reference(wl, **comp)
    n = rgb_channels(C)
    torch.testing.assert_close(col[..., :n], col_ref[..., :n], atol=2e-4,
                               rtol=0)
    torch.testing.assert_close(alpha, alpha_ref, atol=2e-4, rtol=0)
    assert G.launches["tile_worklist"] == G.launches["composite"] == 1
    # the pack kernel against its plain version: a gather, exact
    rec = G.pair_records(wl, *(comp[k] for k in (
        "u", "v", "conic_a", "conic_b", "conic_c", "colors", "opacities")))
    ref_rec = G.pair_records_reference(wl, *(comp[k] for k in (
        "u", "v", "conic_a", "conic_b", "conic_c", "colors", "opacities")))
    assert rec.shape == ref_rec.shape == (wl.n_pairs, G.record_floats(C))
    assert torch.equal(rec, ref_rec)


def test_rasterize_pixels_launches_kernels(cuda):
    args = splat_args(cuda, 2_000, 64, 48, 2, 0.05)
    G.reset_launch_counts()
    out = G.rasterize_pixels(**args)
    assert out.colors.is_cuda and out.colors.shape == (48, 64, 4)
    assert dict(G.launches) == {"tile_worklist": 1, "pair_records": 1,
                                "composite": 1}
    empty = {k: (v[:0] if isinstance(v, torch.Tensor) else v)
             for k, v in args.items()}
    out = G.rasterize_pixels(**empty)
    assert out.n_pairs == 0 and float(out.alpha.abs().max()) == 0.0


FIELDS = {"u": G.GRAD_U, "v": G.GRAD_V, "conic_a": G.GRAD_A,
          "conic_b": G.GRAD_B, "conic_c": G.GRAD_C,
          "opacity": G.GRAD_OPACITY, "absgrad": G.GRAD_ABS,
          "colors": slice(G.GRAD_COLORS, None)}
# kernel C against the plain backward, per field: kernel C rebuilds T by
# division where the plain version scans with cumprod, sums the suffix in
# another order, and adds per-splat sums with atomics in a run-dependent
# order, so the two differ by f32 rounding only
GRAD_RTOL = 1e-4


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("seed,wide", [(0, 0.0), (1, 0.1)])
def test_kernel_c_matches_plain_backward(cuda, seed, wide, C):
    args = splat_args(cuda, 20_000, 200, 136, seed, wide, C)
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    wl = G.tile_worklist(**geo)
    out, alpha, final_T, last = G.composite(wl, **comp, train=True)
    ref = G.composite_reference(wl, **comp, train=True)
    assert torch.equal(last, ref[3])       # the same stop decisions
    torch.testing.assert_close(final_T, ref[2], atol=1e-6, rtol=0)
    rng = np.random.default_rng(seed + 10)
    gcol = torch.tensor(rng.normal(size=out.shape), dtype=torch.float32,
                        device=cuda)
    gal = torch.tensor(rng.normal(size=alpha.shape), dtype=torch.float32,
                       device=cuda)
    G.reset_launch_counts()
    got = G.composite_backward(wl, **comp, final_T=final_T, last=last,
                               grad_colors=gcol, grad_alpha=gal)
    want = G.composite_backward_reference(wl, **comp, grad_colors=gcol,
                                          grad_alpha=gal)
    assert G.launches["composite_backward"] == 1
    assert_grads_close(got, want)


def assert_grads_close(got, want):
    """Kernel C's rows against the plain backward's, per field, three
    ways (GRAD_RTOL)."""
    for name, col in FIELDS.items():
        g, w = got[:, col].flatten(), want[:, col].flatten()
        diff, mag = (g - w).abs(), w.abs()
        scale = float(mag.max())
        assert scale > 0 and float(diff.max()) <= GRAD_RTOL * scale, name
        # the norm, and the median splat: small splats count too
        assert float(torch.linalg.vector_norm(g - w)) <= \
            GRAD_RTOL * float(torch.linalg.vector_norm(w)), name
        nz = mag > 0
        assert float((diff[nz] / mag[nz]).median()) <= GRAD_RTOL, name


def check_b_and_c(args, seed):
    """Kernels A, B (both forms) and C against their plain versions:
    the worklist and ``last`` exactly, T to 1e-6, colours and alpha to
    2e-4, the gradient rows per field to GRAD_RTOL. Returns the
    worklist."""
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    wl = G.tile_worklist(**geo)
    ref = G.tile_worklist_reference(**geo)
    for name in ("tile_ids", "gauss_ids", "ranges", "order"):
        assert torch.equal(getattr(wl, name), getattr(ref, name)), name
    n = rgb_channels(args["colors"].shape[1])
    col, alpha = G.composite(wl, **comp)
    col_t, alpha_t, final_T, last = G.composite(wl, **comp, train=True)
    ref = G.composite_reference(wl, **comp, train=True)
    for c, a in ((col, alpha), (col_t, alpha_t)):
        torch.testing.assert_close(c[..., :n], ref[0][..., :n], atol=2e-4,
                                   rtol=0)
        torch.testing.assert_close(a, ref[1], atol=2e-4, rtol=0)
    assert torch.equal(last, ref[3])
    torch.testing.assert_close(final_T, ref[2], atol=1e-6, rtol=0)
    rng = np.random.default_rng(seed)
    dev = col.device
    gcol = torch.tensor(rng.normal(size=col.shape), dtype=torch.float32,
                        device=dev)
    gal = torch.tensor(rng.normal(size=alpha.shape), dtype=torch.float32,
                       device=dev)
    got = G.composite_backward(wl, **comp, final_T=final_T, last=last,
                               grad_colors=gcol, grad_alpha=gal)
    want = G.composite_backward_reference(wl, **comp, grad_colors=gcol,
                                          grad_alpha=gal)
    assert_grads_close(got, want)
    return wl


# channel counts past 7 (the semantic channel): 8 and 9 share the 64-byte
# record of the instance of width 9; 10 pads to 13; 23 is rgb + depth +
# Cityscapes' 19 classes (instance 25); 29 fills its instance; 30 and 32
# take the widest (160-byte records)
WIDE_CHANNELS = (8, 9, 10, 23, 29, 30, 32)


@pytest.mark.parametrize("C", WIDE_CHANNELS)
def test_wide_channels_match_plain_versions(cuda, C):
    """The pack (exact), B in both forms and C at C channels, the limits
    of check_b_and_c; the channels an instance carries past C are neither
    returned nor given gradients."""
    args = splat_args(cuda, 20_000, 200, 136, C, 0.05, C)
    G.reset_launch_counts()
    wl = check_b_and_c(args, C)
    assert G.launches["composite"] == 2
    assert G.launches["composite_backward"] == 1
    names = ("u", "v", "conic_a", "conic_b", "conic_c", "colors",
             "opacities")
    rec = G.pair_records(wl, *(args[k] for k in names))
    ref = G.pair_records_reference(wl, *(args[k] for k in names))
    assert rec.shape == ref.shape == (wl.n_pairs, G.record_floats(C))
    assert torch.equal(rec, ref)


def test_channels_above_the_limit_raise(cuda):
    C = G.MAX_CHANNELS + 1
    args = splat_args(cuda, 500, 64, 48, 3, 0.0, C)
    with pytest.raises(ValueError, match="MAX_CHANNELS = 32"):
        G.rasterize_pixels(**args)
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    wl = G.tile_worklist(**geo)
    assert wl.n_pairs > 0
    G.reset_launch_counts()
    for call in (lambda: G.composite(wl, **comp),
                 lambda: G.pair_records(wl, *(
                     comp[k] for k in ("u", "v", "conic_a", "conic_b",
                                       "conic_c", "colors", "opacities")))):
        with pytest.raises(ValueError, match="MAX_CHANNELS"):
            call()
    assert not G.launches


def test_kernels_b_c_long_tile_list(cuda):
    """One tile's list longer than 4,096 splats, with opacities low enough
    that no pixel stops: the ring wraps many times forward (B) and back
    (C)."""
    rng = np.random.default_rng(7)
    n, W, H = 6_000, 48, 48
    sigma = rng.uniform(0.5, 2.0, n)
    ca = 1.0 / sigma ** 2

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    args = dict(u=t(rng.uniform(16, 32, n)), v=t(rng.uniform(16, 32, n)),
                conic_a=t(ca), conic_b=t(np.zeros(n)), conic_c=t(ca),
                colors=t(rng.random((n, 4))),
                opacities=t(rng.uniform(0.004, 0.02, n)),
                depths=t(rng.uniform(1.0, 80.0, n)),
                valid=t(np.ones(n, bool), torch.bool),
                radii=t(np.ceil(3 * sigma)), width=W, height=H)
    wl = check_b_and_c(args, 7)
    lengths = wl.ranges[:, 1] - wl.ranges[:, 0]
    assert int(lengths.max()) > 4096


def test_kernels_b_c_ragged_image(cuda):
    """A 17x33 image: partial tiles on both edges."""
    check_b_and_c(splat_args(cuda, 400, 17, 33, 8, 0.1), 8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernels_b_c_adversarial_cull(cuda, seed):
    """The splats at the edges of the per-warp cull (tests/raster_cases.py):
    contours that graze pixel centres, opacities at 1/255 and one ulp
    either side, near-degenerate conics, centres far outside. ``last``
    exactly equal to the plain version's."""
    d = adversarial_cull_splats(64, 48, seed)
    args = {k: torch.tensor(x, device=cuda) for k, x in d.items()}
    check_b_and_c(dict(args, width=64, height=48), seed)


def test_rasterize_pixels_backward_launches_kernel_c(cuda):
    args = splat_args(cuda, 2_000, 64, 48, 4, 0.05)
    leaves = {k: args[k].clone().requires_grad_(True)
              for k in ("u", "v", "conic_a", "conic_b", "conic_c", "colors",
                        "opacities")}
    sink = torch.zeros((2_000, 2), device=cuda, requires_grad=True)
    G.reset_launch_counts()
    out = G.rasterize_pixels(**dict(args, **leaves), absgrad_sink=sink)
    (out.colors.sum() + out.alpha.sum()).backward()
    # one pack, in the forward: kernel C reads the records kernel B read
    assert dict(G.launches) == {"tile_worklist": 1, "pair_records": 1,
                                "composite": 1, "composite_backward": 1}
    for t in list(leaves.values()) + [sink]:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    assert float(sink.grad.max()) > 0


def test_kernel_wrappers_check_inputs(cuda):
    args = splat_args(cuda, 100, 32, 32, 3, 0.0)
    strided = dict(args, u=torch.stack([args["u"], args["u"]], 1)[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        G.rasterize_pixels(**strided)
    with pytest.raises(TypeError, match="float32"):
        G.rasterize_pixels(**dict(args, v=args["v"].double()))
    with pytest.raises(ValueError, match="tensors on"):
        G.rasterize_pixels(**dict(args, u=args["u"].cpu()))


def geometry(device, u, v, radii, depths, valid, W, H):
    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return dict(u=t(u), v=t(v), radii=t(radii), depths=t(depths),
                valid=t(valid, torch.bool), width=W, height=H)


def worklist_case(device, case):
    """Kernel A's inputs for one named case (see test_kernel_a_matches_plain
    for what each exercises)."""
    rng = np.random.default_rng(len(case))
    if case.startswith("ragged"):
        n, W, H = {"ragged_1": (1, 17, 33), "ragged_37": (37, 200, 136),
                   "ragged_20k": (20_000, 200, 136)}[case]
        return geometry(device, rng.uniform(-40, W + 40, n),
                        rng.uniform(-40, H + 40, n),
                        np.ceil(3 * rng.uniform(1.0, 30.0, n)),
                        rng.uniform(1.0, 80.0, n), rng.random(n) > 0.05, W, H)
    if case == "equal_depths":
        n, W, H = 3_000, 128, 96
        return geometry(device, rng.uniform(0, W, n), rng.uniform(0, H, n),
                        np.ceil(3 * rng.uniform(1.0, 20.0, n)),
                        np.full(n, 5.0), np.ones(n, bool), W, H)
    if case == "all_invalid":
        n, W, H = 500, 64, 48
        return geometry(device, rng.uniform(0, W, n), rng.uniform(0, H, n),
                        np.full(n, 9.0), rng.uniform(1.0, 9.0, n),
                        np.zeros(n, bool), W, H)
    if case == "one_splat_every_tile":
        W, H = 200, 136
        return geometry(device, [100.0], [68.0], [400.0], [3.0], [True], W, H)
    if case == "list_past_shared_memory":
        # 40,000 splats over one tile: a list longer than a sort block's
        # shared memory, sorted by passes over device memory
        n, W, H = 40_000, 48, 48
        return geometry(device, rng.uniform(16, 32, n), rng.uniform(16, 32, n),
                        rng.uniform(0.5, 2.0, n), rng.uniform(1.0, 80.0, n),
                        np.ones(n, bool), W, H)
    if case == "many_tiles":
        # 132 x 132 tiles: more than the order block holds in shared memory
        n, W, H = 5_000, 2100, 2100
        return geometry(device, rng.uniform(0, W, n), rng.uniform(0, H, n),
                        np.ceil(3 * rng.uniform(1.0, 40.0, n)),
                        rng.uniform(1.0, 80.0, n), np.ones(n, bool), W, H)
    if case == "scan_unstaged":
        # 250 x 250 tiles: more bins than the scan stages in shared memory
        n, W, H = 3_000, 4000, 4000
        return geometry(device, rng.uniform(0, W, n), rng.uniform(0, H, n),
                        np.ceil(3 * rng.uniform(1.0, 60.0, n)),
                        rng.uniform(1.0, 80.0, n), np.ones(n, bool), W, H)
    raise ValueError(case)


WORKLIST_CASES = ("ragged_1", "ragged_37", "ragged_20k", "equal_depths",
                  "all_invalid", "one_splat_every_tile",
                  "list_past_shared_memory", "many_tiles", "scan_unstaged")


@pytest.mark.parametrize("case", WORKLIST_CASES)
def test_kernel_a_matches_plain(cuda, case):
    """Kernel A bit-equal to the plain worklist, its tile order included:
    ragged image and splat counts, equal depths (ties broken by splat id),
    no valid splat, one splat over every tile, a list longer than shared
    memory holds, more tiles than the order block holds, more than the scan
    stages in shared memory; lists of every
    sort route (a warp's registers, a block's shared memory, device
    memory)."""
    geo = worklist_case(cuda, case)
    G.reset_launch_counts()
    wl = G.tile_worklist(**geo)
    ref = G.tile_worklist_reference(**geo)
    assert G.launches["tile_worklist"] == 1
    assert wl.n_pairs == ref.n_pairs
    for name in ("tile_ids", "gauss_ids", "ranges", "order"):
        got, want = getattr(wl, name), getattr(ref, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    lengths = ref.ranges[:, 1] - ref.ranges[:, 0]
    if case == "list_past_shared_memory":
        assert int(lengths.max()) == 40_000
    if case == "all_invalid":
        assert wl.n_pairs == 0
    if case == "one_splat_every_tile":
        assert bool((lengths == 1).all())


def test_kernel_a_replays_after_its_sync(cuda):
    """The part of kernel A after its host synchronisation (emit and sort)
    run twice on one count gives the same lists: it leaves its counters at
    zero (what a CUDA graph replay needs)."""
    geo = worklist_case(cuda, "ragged_20k")
    bins = G._worklist_bins(**geo)
    first = G._worklist_lists(bins)
    second = G._worklist_lists(bins)
    for name in ("tile_ids", "gauss_ids"):
        assert torch.equal(getattr(first, name), getattr(second, name))


def lidar_condition_args(device, n=300_000, W=320, H=240, seed=0):
    """The condition render's shape (ops.point_raster.
    render_pointcloud_gaussian): a LiDAR-like cloud (a ground plane from 1
    m to 60 m and two walls, in the camera's frame) as isotropic splats of
    the constant pixel sigma 6.4 (0.01 x 0.5 x 1280), radius 3 sigma,
    opacity 1, channels rgb and z. 78 of the 300 tiles hold lists past
    8,192 pairs (the sort's passes over device memory), the longest
    68,408."""
    rng = np.random.default_rng(seed)
    n_g = n * 4 // 5
    ground = np.stack([rng.uniform(-20, 20, n_g),
                       1.6 + rng.normal(0, 0.02, n_g),
                       rng.uniform(1.0, 60, n_g)], -1)
    n_w = n - n_g
    wall = np.stack([rng.choice([-8.0, 8.0], n_w), rng.uniform(-4, 1.6, n_w),
                     rng.uniform(1.0, 60, n_w)], -1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    fx, z = 0.6 * W, pts[:, 2]
    sigma = 0.01 * 0.5 * 1280
    inv = np.full(n, 1.0 / sigma ** 2)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(u=t(fx * pts[:, 0] / z + W / 2),
                v=t(fx * pts[:, 1] / z + H / 2), conic_a=t(inv),
                conic_b=t(np.zeros(n)), conic_c=t(inv),
                colors=t(np.concatenate([rng.uniform(0.1, 0.9, (n, 3)),
                                         z[:, None]], 1)),
                opacities=t(np.ones(n)), depths=t(z),
                valid=t(z > 0.2, torch.bool), radii=t(np.full(n, 3 * sigma)),
                width=W, height=H)


def test_kernels_at_the_condition_render_shape(cuda):
    """Kernels A, the pack and B on the condition render's shape (4
    channels, opacity 1, lists far past 8,192) against their plain
    versions: the worklist and the records equal, rgb and alpha to atol
    2e-4 and the z channel to 2e-4 of the largest z (phase 2's limits)."""
    args = lidar_condition_args(cuda)
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    wl = G.tile_worklist(**geo)
    ref = G.tile_worklist_reference(**geo)
    assert wl.n_pairs == ref.n_pairs
    for name in ("tile_ids", "gauss_ids", "ranges", "order"):
        assert torch.equal(getattr(wl, name), getattr(ref, name)), name
    lengths = ref.ranges[:, 1] - ref.ranges[:, 0]
    assert int((lengths > 8192).sum()) >= 50
    pack = [comp[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                              "colors", "opacities")]
    rec = G.pair_records(wl, *pack)
    assert torch.equal(rec, G.pair_records_reference(wl, *pack))
    col, alpha = G.composite(wl, **comp, records=rec)
    col_ref, alpha_ref = G.composite_reference(wl, **comp)
    torch.testing.assert_close(col[..., :3], col_ref[..., :3], atol=2e-4,
                               rtol=0)
    torch.testing.assert_close(alpha, alpha_ref, atol=2e-4, rtol=0)
    zmax = float(args["depths"].max())
    torch.testing.assert_close(col[..., 3], col_ref[..., 3],
                               atol=2e-4 * zmax, rtol=0)
    assert float(alpha.mean()) > 0.5


def test_condition_render_launches_kernels(cuda):
    """render_pointcloud_gaussian on CUDA tensors: one launch each of A,
    the pack and B, none of a plain version; the image as on CPU tensors
    (the plain versions) to PSNR > 50 dB (the CPU's exp and the card's
    expf can put a pair on the other side of the 1/255 gate)."""
    from street_crafter_tpu_torch.ops.point_raster import \
        render_pointcloud_gaussian
    rng = np.random.default_rng(4)
    n = 20_000
    pts = np.stack([rng.uniform(-10, 10, n), np.full(n, 1.6),
                    rng.uniform(2, 40, n)], -1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    K = np.array([[120.0, 0, 96], [0, 120.0, 64], [0, 0, 1]], np.float32)
    inputs = [np.eye(4, dtype=np.float32), K, pts, cols]
    G.reset_launch_counts()
    got = render_pointcloud_gaussian(*(torch.tensor(a, device=cuda)
                                       for a in inputs), 128, 192)
    assert dict(G.launches) == {"tile_worklist": 1, "pair_records": 1,
                                "composite": 1}
    want = render_pointcloud_gaussian(*(torch.tensor(a) for a in inputs),
                                      128, 192)
    for a, b in ((got.rgb, want.rgb), (got.acc, want.acc)):
        mse = float(((a.cpu() - b) ** 2).mean())
        assert -10 * np.log10(mse + 1e-20) > 50.0
    # the ground below the horizon (0.432 in the plain version)
    assert float(got.acc[64:].mean()) > 0.4


@pytest.mark.parametrize("C", (3, 4))
def test_kernels_b_c_read_shared_records(cuda, C):
    """Records packed once and handed to B (both forms) and C: B's outputs
    equal those of B packing its own, bit for bit, and C is within its
    limits of the plain backward; one pack in all."""
    args = splat_args(cuda, 20_000, 200, 136, 5, 0.1, C)
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    wl = G.tile_worklist(**geo)
    G.reset_launch_counts()
    rec = G.pair_records(wl, *(comp[k] for k in (
        "u", "v", "conic_a", "conic_b", "conic_c", "colors", "opacities")))
    shared = G.composite(wl, **comp, train=True, records=rec)
    eval_shared = G.composite(wl, **comp, records=rec)
    assert dict(G.launches) == {"pair_records": 1, "composite": 2}
    own = G.composite(wl, **comp, train=True)
    for a, b in zip(shared, own):
        assert torch.equal(a, b)
    for a, b in zip(eval_shared, own[:2]):
        assert torch.equal(a, b)
    rng = np.random.default_rng(C)
    gcol = torch.tensor(rng.normal(size=own[0].shape), dtype=torch.float32,
                        device=cuda)
    gal = torch.tensor(rng.normal(size=own[1].shape), dtype=torch.float32,
                       device=cuda)
    G.reset_launch_counts()
    got = G.composite_backward(wl, **comp, final_T=shared[2], last=shared[3],
                               grad_colors=gcol, grad_alpha=gal, records=rec)
    assert dict(G.launches) == {"composite_backward": 1}
    want = G.composite_backward_reference(wl, **comp, grad_colors=gcol,
                                          grad_alpha=gal)
    assert_grads_close(got, want)


@pytest.mark.parametrize("data", ["make_cand", "capped", *CASES, "full",
                                  "empty"])
@pytest.mark.parametrize("name,variant,kb", list(PV.RUNS))
def test_row_compaction_kernels_match_plain(cuda, name, variant, kb, data):
    """K1's row-compaction variants (kernel A's variant bench) against their
    plain version: the counts, every kept slot and the checksums exactly,
    one launch a call. Candidates: 13 coarse tiles of make_cand(0);
    ``capped``: there a third of the candidates span the whole coarse tile
    (rows outgrow kf = 1024) and tile 2 holds a dead candidate in its third
    block of 128 (its walks stop there); the chunk-edge sets of row_compact_cases.py; ``full``: the
    bench's [117, 4096, 11] make_cand(0); ``empty``: 2 tiles of no
    candidates (every count 0, no kernel launched)."""
    if data in CASES:
        cand = chunk_case(data, kb)
    elif data == "empty":
        cand = np.zeros((2, 0, RC.A), np.float32)
    else:
        cand = PV.make_cand(0, PV.TC if data == "full" else 13)
    if data == "capped":
        wide = np.random.default_rng(2).random(cand.shape[:2]) < 0.33
        cand[..., RC.Y0] = np.where(wide, -1.0, cand[..., RC.Y0])
        cand[..., RC.Y1] = np.where(wide, 1000.0, cand[..., RC.Y1])
        cand[2, 300, RC.DEPTH] = 2e10
    x = torch.tensor(cand, device=cuda)
    RC.reset_launch_counts()
    comp, counts = RC.compact_rows(x, variant, kb)
    assert dict(RC.launches) == ({} if data == "empty" else {name: 1})
    ref_comp, ref_counts = RC.compact_rows_reference(x, variant, kb)
    assert torch.equal(counts, ref_counts)
    if comp is not None:
        assert PV.kept_equal(comp, ref_comp, ref_counts)
    assert torch.equal(RC.checksums(comp, counts, variant),
                       RC.checksums(ref_comp, ref_counts, variant))
    if data == "capped":
        assert int(ref_counts.max()) > RC.KF


# ---------------------------------------------------------------------------
# kernels D (attention forward), E and F (the temporal stage) against their
# plain versions, in bf16. Tolerances: the largest error within 2e-2 of the
# largest |output| and the median within 2e-3: the kernels sum in another
# order, kernel D rounds its probabilities against a running max, and the
# plain versions round the same bf16 intermediates, so a bf16 ulp or two of
# drift is expected where an intermediate rounds the other way. The scale
# is floored at 2^-8: with one key (Skv = 1) the reference dk and dq vanish
# (a softmax over one key has no gradient with respect to its score), and
# both sides hold only rounding noise, ~1e-6.

from street_crafter_tpu_torch.ops import flash_attention as FA  # noqa: E402
from street_crafter_tpu_torch.ops import temporal_block as TB  # noqa: E402

BF16_MAX, BF16_MED = 2e-2, 2e-3


def bf16_errors(got, want):
    d = (got.float() - want.float()).abs()
    scale = max(float(want.float().abs().max()), 2.0 ** -8)
    return float(d.max()) / scale, float(d.median()) / scale


# kernels D and G work in tiles of 128 queries (D) and 128 keys (G), with
# 64-query (32 at head dim 128) q tiles streaming through G: these lengths
# sit on, just inside and just past the tile edges
EDGES = (1, 127, 128, 129, 300)
RAGGED = [(1, sq, skv, 2, d) for d in (64, 128) for sq in EDGES
          for skv in EDGES]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 100, 75, 3, 64),
                                          (1, 300, 257, 2, 128),
                                          (2, 576, 576, 4, 64)] + RAGGED)
def test_kernel_d_matches_plain_attention(cuda, b, sq, skv, h, d, with_lse):
    """Kernel D, the sampling form (no lse) and the training form (o and
    lse), against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(sq)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=cuda)
               .to(torch.bfloat16) for n in (sq, skv, skv))
    FA.reset_launch_counts()
    if with_lse:
        got = FA._flash_cuda(q, k, v, with_lse=True)
        want = FA.flash_attention_lse_reference(q, k, v)
    else:
        got = (FA.flash_attention(q, k, v),)
        want = (FA.flash_attention_reference(q, k, v),)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention_lse" if with_lse
                       else "flash_attention"] == 1
    for x, y in zip(got, want):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())
        worst, med = bf16_errors(x, y)
        assert worst <= BF16_MAX and med <= BF16_MED


def _stage_inputs(cuda, B, T, S, C, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * sc).to(
            torch.bfloat16)
    inner = 4 * C
    w = dict(norm_in_s=1 + r(C, sc=.1), norm_in_b=r(C, sc=.1),
             ffin_w1=r(2 * inner, C, sc=C ** -.5), ffin_b1=r(2 * inner, sc=.1),
             ffin_w2=r(C, inner, sc=inner ** -.5), ffin_b2=r(C, sc=.1),
             norm1_s=1 + r(C, sc=.1), norm1_b=r(C, sc=.1),
             wqkv=r(3 * C, C, sc=C ** -.5), wout=r(C, C, sc=C ** -.5),
             bout=r(C, sc=.1), norm3_s=1 + r(C, sc=.1), norm3_b=r(C, sc=.1),
             ff_w1=r(2 * inner, C, sc=C ** -.5), ff_b1=r(2 * inner, sc=.1),
             ff_w2=r(C, inner, sc=inner ** -.5), ff_b2=r(C, sc=.1))
    return r(B * T, S, C), r(B * T, C, sc=.3), r(B, C, sc=.2), w


# head dims 64, 32 and 16, and up to the 32 frames the attention pads T to
@pytest.mark.parametrize("B,T,S,C,heads", [(2, 25, 48, 64, 1),
                                           (1, 5, 100, 320, 5),
                                           (2, 3, 16, 32, 2),
                                           (2, 3, 48, 64, 2),
                                           (2, 7, 48, 32, 2),
                                           (2, 32, 48, 320, 5)])
def test_kernel_e_matches_plain_stage(cuda, B, T, S, C, heads):
    h, emb, bias, w = _stage_inputs(cuda, B, T, S, C, C + S)
    args = (h, emb, 0.3, bias, *[w[k] for k in TB._BLOCK_WEIGHTS])
    kw = dict(num_frames=T, heads=heads, dim_head=C // heads)
    TB.reset_launch_counts()
    got = TB.temporal_block_fused(*args, **kw)
    want = TB.temporal_block_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert TB.launches["temporal_block_fused"] == 1
    worst, med = bf16_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


@pytest.mark.parametrize("B,T,S,C,heads", [(2, 25, 75, 640, 10),
                                           (1, 25, 16, 1280, 20)])
def test_kernel_f_matches_plain_attention_stage(cuda, B, T, S, C, heads):
    h, _, bias, w = _stage_inputs(cuda, B, T, S, C, C + S)
    names = ("norm1_s", "norm1_b", "wqkv", "wout", "bout")
    args = (h, bias, *[w[k] for k in names])
    kw = dict(num_frames=T, heads=heads, dim_head=C // heads)
    TB.reset_launch_counts()
    got = TB.temporal_attention_fused(*args, **kw)
    want = TB.temporal_attention_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert TB.launches["temporal_attention_fused"] == 1
    worst, med = bf16_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


@pytest.mark.parametrize("kernel", ["E", "F"])
def test_temporal_kernels_refuse_unaligned_tensors(cuda, kernel):
    """The GEMMs of E and F read through TMA from a 16-byte aligned base:
    an h that starts one element into its storage is refused before
    launch."""
    B, T, S, C, heads = 1, 5, 16, 64, 1
    h, emb, bias, w = _stage_inputs(cuda, B, T, S, C, 9)
    flat = torch.zeros(h.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(h.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    kw = dict(num_frames=T, heads=heads, dim_head=C // heads)
    TB.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "E":
            TB.temporal_block_fused(shifted, emb, 0.3, bias,
                                    *[w[k] for k in TB._BLOCK_WEIGHTS], **kw)
        else:
            TB.temporal_attention_fused(
                shifted, bias, *[w[k] for k in ("norm1_s", "norm1_b", "wqkv",
                                                "wout", "bout")], **kw)
    assert not TB.launches


# the GEMM pieces of E and F run tiles of 128 rows x 128 columns (GEGLU:
# 64) in stages of 64 along K: these M and K cross every tile edge, and N
# (by K) is no multiple of a tile (75 is odd: the unpaired stores)
GEMM_N = {32: 200, 64: 75, 320: 330, 1280: 136}


@pytest.mark.parametrize("epi", list(TB.EPILOGUES))
@pytest.mark.parametrize("M", [1, 127, 129, 300])
@pytest.mark.parametrize("K", list(GEMM_N))
def test_gemm_epilogues_match_plain_torch(cuda, epi, M, K):
    """Each epilogue of the GEMM piece against its plain version (the same
    bf16 roundings as kernel E's and F's plain versions)."""
    N = GEMM_N[K]
    g = torch.Generator(device=cuda).manual_seed(M * K + len(epi))

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * sc).to(
            torch.bfloat16)
    nw = 2 * N if epi == "geglu" else N
    # kernel E's QKV product has no bias: odd M runs "store" without one
    bias = None if epi == "store" and M % 2 else r(nw, sc=.1)
    a, w = r(M, K), r(nw, K, sc=K ** -.5)
    kw = {}
    if epi != "store" and epi != "geglu":
        kw["resid"] = r(M, N)
    if epi in ("resid_bias", "add_f32"):
        rpb = 100 if M == 300 else M
        kw.update(rowbias=r(M // rpb, N, sc=.2), rows_per_batch=rpb)
    if epi == "resid_blend":
        kw.update(blend_h=r(M, N), alpha=0.3)
    TB.reset_launch_counts()
    got = TB.temporal_gemm(epi, a, w, bias, **kw)
    want = TB.temporal_gemm_reference(epi, a, w, bias, **kw)
    torch.cuda.synchronize()
    assert TB.launches["temporal_gemm"] == 1
    assert got.shape == want.shape == (M, N)
    assert bool(torch.isfinite(got.float()).all())
    worst, med = bf16_errors(got, want)
    assert worst <= BF16_MAX and med <= BF16_MED


def test_vdm_kernel_wrappers_check_inputs(cuda):
    q = torch.zeros((1, 300, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(*(torch.zeros((1, 300, 2, 80), device=cuda,
                                         dtype=torch.bfloat16),) * 3)
    h, _, bias, w = _stage_inputs(cuda, 1, 40, 16, 64, 0)
    with pytest.raises(ValueError, match="32 frames"):
        TB.temporal_attention_fused(h, bias, w["norm1_s"], w["norm1_b"],
                                    w["wqkv"], w["wout"], w["bout"],
                                    num_frames=40, heads=1, dim_head=64)


def _attn_case(cuda, b, sq, skv, h, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=cuda)
               .to(torch.bfloat16) for n in (sq, skv, skv))
    do = torch.randn((b, sq, h, d), generator=g, device=cuda).to(
        torch.bfloat16)
    return q, k, v, do


@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 100, 75, 3, 64),
                                          (1, 75, 100, 2, 128),
                                          (1, 300, 257, 2, 64),
                                          (2, 576, 576, 4, 64)] + RAGGED)
def test_attention_training_kernels_match_plain(cuda, b, sq, skv, h, d):
    """Kernel D with lse, G and H against their plain versions on the same
    inputs (seeded cotangents), in bf16."""
    q, k, v, do = _attn_case(cuda, b, sq, skv, h, d, sq + skv)
    FA.reset_launch_counts()
    o, lse = FA._flash_cuda(q, k, v, with_lse=True)
    o_ref, lse_ref = FA.flash_attention_lse_reference(q, k, v)
    delta = FA.attention_delta(o_ref, do)
    dq, dk, dv = FA._flash_backward_cuda(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = FA.flash_attention_bwd_dkv_reference(q, k, v, do,
                                                          lse_ref, delta)
    dq_ref = FA.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention_lse"] == 1
    assert FA.launches["flash_attention_bwd_dkv"] == 1
    assert FA.launches["flash_attention_bwd_dq"] == 1
    for got, want in ((o, o_ref), (lse, lse_ref), (dq, dq_ref),
                      (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        worst, med = bf16_errors(got, want)
        assert worst <= BF16_MAX and med <= BF16_MED


def test_attention_function_backward_launches_g_and_h(cuda):
    q, k, v, do = _attn_case(cuda, 1, 300, 260, 2, 64, 5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    FA.reset_launch_counts()
    out = FA.flash_attention(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    assert dict(FA.launches) == {"flash_attention_lse": 1,
                                 "flash_attention_bwd_dkv": 1,
                                 "flash_attention_bwd_dq": 1}
    for t in (q, k, v):
        assert t.grad is not None and t.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(t.grad).all())
    with torch.no_grad():
        FA.flash_attention(q, k, v)
    assert FA.launches["flash_attention"] == 1


def test_attention_training_wrappers_check_inputs(cuda):
    q, k, v, do = _attn_case(cuda, 1, 300, 300, 2, 64, 6)
    with pytest.raises(ValueError, match="tensors on"):
        FA.flash_attention(q, k.cpu(), v)
    wide = torch.zeros((1, 300, 2, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        FA._flash_cuda(wide[..., ::2], k, v, with_lse=True)
    lse = torch.zeros((1, 2, 300), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        FA._flash_backward_cuda(q, k, v, do.float(), lse, lse)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((1, 300, 2, 32), device=cuda, dtype=torch.bfloat16)
        FA._flash_backward_cuda(x, x, x, x, lse, lse)


@pytest.mark.parametrize("kernel", ["D", "D with lse", "G", "H"])
def test_attention_kernels_refuse_unaligned_tensors(cuda, kernel):
    """TMA reads from a 16-byte aligned base: a contiguous tensor that
    starts one element into its storage is refused before launch."""
    q, k, v, do = _attn_case(cuda, 1, 130, 130, 2, 64, 7)
    flat = torch.zeros(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    lse = torch.zeros((1, 2, 130), device=cuda)
    FA.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "D":
            FA.flash_attention(shifted, k, v)
        elif kernel == "D with lse":
            FA._flash_cuda(q, shifted, v, with_lse=True)
        elif kernel == "G":
            FA._flash_bwd_dkv_cuda(q, k, v, shifted, lse, lse)
        else:
            FA._flash_bwd_dq_cuda(q, k, v, shifted, lse, lse)
    assert not FA.launches


# the f32 forms of D, G and H (csrc/flash_attention_f32.cu, 3xTF32) against
# the plain versions in f32 (TF32 off): atol 2e-5 + rtol 1e-4 of the
# largest |reference|, f32 sums in another order. Plain TF32 products
# (10 mantissa bits) miss this by ~10x at these lengths.
F32_ATOL, F32_RTOL = 2e-5, 1e-4
F32_RAGGED = [(1, sq, skv, 2, d) for d in (64, 128)
              for sq in (100, 300, 1000) for skv in (100, 300, 1000)]
# the edges of the f32 D's, G's and H's tiles (D blocks queries and tiles
# keys as H does): 1, one under and one over the streamed tile (32), the
# ring's two stages (64, also the block of 64 rows at head dim 128) and the
# block of 128 rows (head dim 64, also D's ring of four stages); none but
# 1 a multiple of 8. One key (Skv = 1) goes with Sq up to 33 only: there
# p = 1 and ds = p (dp - delta) scale cancels to 0, so dK's plain f32 value
# is rounding noise growing with Sq, and past ~64 queries 3xTF32's noise
# (the f32 G's before this design as well) passes the 2e-5 absolute limit
F32_EDGES = (1, 31, 33, 63, 65, 127, 129)
F32_RAGGED += [(1, sq, skv, 2, d) for d in (64, 128)
               for sq in F32_EDGES for skv in F32_EDGES
               if skv > 1 or sq <= 33]
# B > 1 and H > 1 with Sq != Skv both ways: a tensor map that read the next
# batch or head, or a row stride of the wrong length, would show
F32_RAGGED += [(2, sq, skv, 3, d) for d in (64, 128)
               for sq, skv in ((129, 65), (65, 129))]
# the main path's: one CFG eval's three levels (sampling), a train step's
F32_SAMPLING = [(50, 9216, 5, 64), (50, 2304, 10, 64), (50, 576, 20, 64)]
F32_TRAINING = [(25, 9216, 5, 64), (25, 2304, 10, 64), (25, 576, 20, 64)]


@pytest.fixture
def exact_f32():
    """TF32 off for torch's own f32 products while a test runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def assert_f32_close(got, want, what):
    """Within the f32 limit; prints the error's share of it (``-rA`` shows
    the shares of passed tests)."""
    assert got.shape == want.shape and got.dtype == torch.float32, what
    assert bool(torch.isfinite(got).all()), what
    err = float((got - want).abs().max())
    limit = F32_ATOL + F32_RTOL * float(want.abs().max())
    print(f"f32 error share {what}: {err / limit:.4f}")
    assert err <= limit, f"{what}: {err:.3e} > {limit:.3e}"


def _f32_case(cuda, b, sq, skv, h, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=cuda)
               for n in (sq, skv, skv))
    do = torch.randn((b, sq, h, d), generator=g, device=cuda)
    return q, k, v, do


def check_f32_training_forms(q, k, v, do):
    """D with lse, G and H in f32 against their plain versions (the plain
    lse and delta feed both backwards)."""
    FA.reset_launch_counts()
    o, lse = FA._flash_cuda(q, k, v, with_lse=True)
    o_ref, lse_ref = FA.flash_attention_lse_reference(q, k, v)
    delta = FA.attention_delta(o_ref, do)
    dk, dv = FA._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta)
    dq = FA._flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = FA.flash_attention_bwd_dkv_reference(q, k, v, do,
                                                          lse_ref, delta)
    dq_ref = FA.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    for name in ("flash_attention_lse_f32", "flash_attention_bwd_dkv_f32",
                 "flash_attention_bwd_dq_f32"):
        assert FA.launches[name] == 1, dict(FA.launches)
    for name, got, want in (("o (lse form)", o, o_ref), ("lse", lse, lse_ref),
                            ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        assert_f32_close(got, want, name)


@pytest.mark.parametrize("b,sq,skv,h,d", F32_RAGGED)
def test_f32_forms_match_plain_versions(cuda, exact_f32, b, sq, skv, h, d):
    """The four f32 forms (D, D with lse, G, H) at ragged lengths."""
    q, k, v, do = _f32_case(cuda, b, sq, skv, h, d, sq + 7 * skv + d)
    FA.reset_launch_counts()
    o = FA.flash_attention(q, k, v)
    want = FA.flash_attention_reference(q, k, v)
    assert FA.launches["flash_attention_f32"] == 1
    assert_f32_close(o, want, "o")
    check_f32_training_forms(q, k, v, do)


# one key for the forward alone, up to 1000 queries (B, H > 1): p = 1 and
# o is v's row; the backward's cancellation at one key does not reach it
F32_ONE_KEY = [(2, sq, 1, 3, d) for d in (64, 128)
               for sq in (63, 65, 127, 129, 1000)]


@pytest.mark.parametrize("b,sq,skv,h,d", F32_ONE_KEY)
def test_f32_forward_at_one_key(cuda, exact_f32, b, sq, skv, h, d):
    """D and D with lse in f32 at one key: o against the plain version and
    against v's row, lse against the plain version."""
    q, k, v, _ = _f32_case(cuda, b, sq, skv, h, d, sq + d)
    FA.reset_launch_counts()
    o = FA.flash_attention(q, k, v)
    o_lse, lse = FA._flash_cuda(q, k, v, with_lse=True)
    o_ref, lse_ref = FA.flash_attention_lse_reference(q, k, v)
    torch.cuda.synchronize()
    assert dict(FA.launches) == {"flash_attention_f32": 1,
                                 "flash_attention_lse_f32": 1,
                                 "flash_attention_lse_reference": 1}
    for name, got, want in (("o", o, o_ref), ("o (lse form)", o_lse, o_ref),
                            ("o against v", o, v.expand_as(o)),
                            ("lse", lse, lse_ref)):
        assert_f32_close(got, want, name)


@pytest.mark.parametrize("b,s,h,d", F32_SAMPLING)
def test_f32_forward_at_the_sampling_shapes(cuda, exact_f32, b, s, h, d):
    q, k, v, _ = _f32_case(cuda, b, s, s, h, d, s)
    FA.reset_launch_counts()
    o = FA.flash_attention(q, k, v)
    # the plain o of the lse form, computed in (batch, head) chunks: the
    # scores of [50, 9216, 5, 64] in one piece take 79 GiB
    want, _ = FA.flash_attention_lse_reference(q, k, v)
    assert dict(FA.launches) == {"flash_attention_f32": 1,
                                 "flash_attention_lse_reference": 1}
    assert_f32_close(o, want, "o")


@pytest.mark.parametrize("b,s,h,d", F32_TRAINING)
def test_f32_training_forms_at_the_training_shapes(cuda, exact_f32, b, s, h,
                                                   d):
    check_f32_training_forms(*_f32_case(cuda, b, s, s, h, d, s + 1))


def test_tf32_products_read_f32_operands_with_13_bits_cleared(cuda):
    """The f32 D, G and H's split relies on a TF32 product reading an f32
    operand with its low 13 mantissa bits cleared (``tf32_read``), neither
    rounded nor whole: one product must read each operand, A then B, so.
    The values carry every low-bit class: all 13 set (rounding would
    carry), exactly half a TF32 step, random."""
    g = torch.Generator().manual_seed(19)
    x = torch.randn((64, 8), generator=g)
    bits = x.view(torch.int32)
    bits[:16] |= 0x1FFF
    bits[16:32] = (bits[16:32] & -8192) | 0x1000
    eye = torch.eye(8)
    rows = torch.eye(8).repeat(8, 1)  # row m is the unit vector m % 8
    FA.reset_launch_counts()
    d_a = FA.tf32_product_probe(x.to(cuda), eye.to(cuda)).cpu()
    d_b = FA.tf32_product_probe(rows.to(cuda), x[:8].contiguous().to(cuda))
    torch.cuda.synchronize()
    assert dict(FA.launches) == {"tf32_probe_f32": 2}
    assert torch.equal(d_a, FA.tf32_read(x))
    assert torch.equal(d_b.cpu(), FA.tf32_read(x[:8]).T.repeat(8, 1))


def test_f32_wrappers_refuse_mixed_dtypes_and_float16(cuda):
    q, k, v, do = _f32_case(cuda, 1, 300, 300, 2, 64, 3)
    lse = torch.zeros((1, 2, 300), device=cuda)
    FA.reset_launch_counts()
    with pytest.raises(TypeError, match="float32, got torch.float16"):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k must be torch.float32"):
        FA.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="v must be torch.bfloat16"):
        FA._flash_cuda(q.bfloat16(), k.bfloat16(), v, with_lse=True)
    with pytest.raises(TypeError, match="do must be torch.float32"):
        FA._flash_bwd_dkv_cuda(q, k, v, do.bfloat16(), lse, lse)
    with pytest.raises(TypeError, match="float32, got torch.float16"):
        FA._flash_bwd_dq_cuda(q.half(), k, v, do, lse, lse)
    assert not FA.launches


def test_attention_function_backward_launches_f32_g_and_h(cuda, exact_f32):
    """``flash_attention``'s autograd Function in f32: the f32 D with lse
    forward, the f32 G and H backward, gradients as the plain versions'."""
    q, k, v, do = _f32_case(cuda, 1, 300, 260, 2, 64, 5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    FA.reset_launch_counts()
    out = FA.flash_attention(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    assert dict(FA.launches) == {"flash_attention_lse_f32": 1,
                                 "flash_attention_bwd_dkv_f32": 1,
                                 "flash_attention_bwd_dq_f32": 1}
    o_ref, lse_ref = FA.flash_attention_lse_reference(q.detach(), k.detach(),
                                                      v.detach())
    delta = FA.attention_delta(o_ref, do)
    dk_ref, dv_ref = FA.flash_attention_bwd_dkv_reference(
        q.detach(), k.detach(), v.detach(), do, lse_ref, delta)
    dq_ref = FA.flash_attention_bwd_dq_reference(
        q.detach(), k.detach(), v.detach(), do, lse_ref, delta)
    for name, got, want in (("o", out.detach(), o_ref), ("dq", q.grad, dq_ref),
                            ("dk", k.grad, dk_ref), ("dv", v.grad, dv_ref)):
        assert_f32_close(got, want, name)


def sky_mlp_step(device):
    """One GS train step with the cubemap sky, the colour MLP and the sky's
    MLP, on ``device``, from a seeded state: (launch counts, the first
    Adam moments of the texture and of every MLP leaf, = 0.1 x their
    gradients)."""
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.datasets.cameras import Camera
    from street_crafter_tpu_torch.models.gs.color_mlp import init_color_mlp
    from street_crafter_tpu_torch.models.gs.params import \
        init_pool_from_points
    from street_crafter_tpu_torch.models.gs.scene import SceneParams
    from street_crafter_tpu_torch.training.gs_trainer import (
        init_train_state, make_train_step)
    rng = np.random.default_rng(6)
    n = 4000
    pts = np.stack([rng.uniform(-6, 6, n), rng.uniform(-1, 3, n),
                    rng.uniform(6, 30, n)], -1).astype(np.float32)
    bkgd = init_pool_from_points(pts, rng.uniform(size=(n, 3)),
                                 capacity=n, sh_degree=1, device=device)

    def mlp(seed):
        g = torch.Generator().manual_seed(seed)
        return {k: (v + 0.05 * torch.randn(v.shape, generator=g)).to(device)
                for k, v in init_color_mlp(g).items()}

    params = SceneParams(
        bkgd=bkgd, actors=None, sky=None, opt_trans=None, opt_theta=None,
        sky_cubemap=torch.tensor(rng.uniform(0.1, 0.9, (6, 64, 64, 3)),
                                 dtype=torch.float32, device=device),
        color_corr=None, color_corr_sky=None, pose_corr_quat=None,
        pose_corr_trans=None, color_mlp=mlp(0), color_mlp_sky=mlp(1))
    cfg = default_config()
    cfg.model.gaussian.sh_degree = 1
    cfg.optim.lambda_lpips = 0.0
    cfg.optim.lambda_color_correction = 0.1
    W, H = 320, 192
    K = np.array([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, -0.1, 0.3]
    cam = Camera.from_c2w(c2w, K, W, H, device=device)
    batch = {"frame_idx": 0, "frame": 0.0, "cam_id": 0, "timestamp": 0.0,
             "image_idx": 0, "gt_image": torch.tensor(
                 rng.uniform(size=(H, W, 3)), dtype=torch.float32,
                 device=device)}
    state = init_train_state(params)
    step = make_train_step(cfg, None, spatial_lr_scale=1.0,
                           active_sh_degree=1)
    G.reset_launch_counts()
    step(state, cam, batch)
    return dict(G.launches), {k: v.cpu() for k, v in state.adam_misc.m.items()}


def test_gs_step_with_cubemap_and_mlp(cuda):
    """A GS step with the cubemap sky and the colour MLPs on the card: one
    rasterization (kernels A, the pack, B and C once each, no plain
    version; C on its forward's records, so one pack), and the texture's
    and every MLP leaf's gradient as on the CPU's plain path to 1e-3 of
    each leaf's largest (the kernels' f32 sums run in another order)."""
    counts, got = sky_mlp_step(cuda)
    assert counts == {"tile_worklist": 1, "pair_records": 1, "composite": 1,
                      "composite_backward": 1}
    plain_counts, want = sky_mlp_step(torch.device("cpu"))
    assert plain_counts == {"tile_worklist_reference": 1,
                            "composite_reference": 1,
                            "composite_backward_reference": 1}
    assert sorted(got) == sorted(want) and "sky_cubemap" in got
    assert len(got) == 1 + 2 * 8
    for k, w in want.items():
        assert w.abs().max() > 0, k
        err = (got[k] - w).abs().max() / w.abs().max()
        assert err < 1e-3, (k, float(err))


@pytest.mark.parametrize("shape", [(1,), (1000,), (4097,), (8, 4, 16),
                                   (2, 8, 128)])
def test_x2_kernel_matches_plain(cuda, shape):
    """The SPMD bridge's x2 kernel (csrc/kernel_shard.cu) against its plain
    version: exact (one f32 multiply by 2), on ragged lengths across the
    256-thread blocks and on the bridge's shapes; one launch a call."""
    from street_crafter_tpu_torch.parallel import kernel_shard as KS
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(
        cuda)
    KS.reset_launch_counts()
    out = KS.x2(x)
    torch.cuda.synchronize()
    assert KS.launches == {"x2": 1}
    assert torch.equal(out, KS.x2_reference(x))
    with pytest.raises(ValueError, match="contiguous"):
        KS.x2(x.reshape(-1)[::2] if x.numel() > 1 else x.expand(2))


# -- kernel Q: the W8A8 int8 convolution ------------------------------------

Q_CASES = [  # N, C, O, H, W, stride, channels-last, dtype
    (2, 5, 6, 7, 9, 1, False, torch.float32),
    (3, 37, 13, 9, 11, 2, True, torch.float32),
    (2, 64, 130, 17, 33, 1, True, torch.bfloat16),
    (1, 300, 40, 8, 8, 2, False, torch.bfloat16),
    (4, 320, 320, 18, 32, 1, True, torch.bfloat16),
    (2, 960, 640, 9, 16, 1, False, torch.bfloat16),
    (2, 1280, 1280, 9, 16, 2, True, torch.bfloat16),
    # the tiling's edges: the level-3 latent (9 rows in 8-row tiles) at
    # stride 1 and 2 in the other layouts; a width no tile width divides;
    # O = 320 and 1280 (whole 160-column tiles); C = 960 and 1920 (K slices
    # across taps); full-width UNet shapes with N = 2 in both layouts
    (2, 64, 320, 9, 16, 1, True, torch.float32),
    (3, 128, 160, 9, 16, 2, False, torch.float32),
    (1, 64, 320, 72, 100, 1, False, torch.bfloat16),
    (1, 64, 160, 72, 100, 2, True, torch.float32),
    (2, 320, 320, 36, 64, 2, False, torch.bfloat16),
    (1, 640, 1280, 18, 32, 1, False, torch.float32),
    (1, 960, 640, 18, 32, 1, True, torch.bfloat16),
    (1, 1920, 1280, 9, 16, 1, False, torch.bfloat16),
    (2, 320, 320, 72, 128, 1, False, torch.bfloat16),
    (2, 640, 640, 72, 128, 1, True, torch.bfloat16)]


@pytest.mark.parametrize("N,C,O,H,W,stride,nhwc,dtype", Q_CASES)
def test_int8_conv_matches_plain(cuda, N, C, O, H, W, stride, nhwc, dtype):
    """Kernel Q (csrc/int8_conv.cu) against its plain version on the card:
    the int32 products and both scales exactly equal (integer sums, the
    same float32 scale arithmetic), the outputs bit-equal in float32 and
    within 1 ulp in bf16 (the epilogue's multiply and add kept apart, as
    in the plain version). Odd sizes and channel counts that are not a
    multiple of the kernel's 64-channel slice cross every tile edge; NCHW
    and channels-last inputs, each kept in the output."""
    from street_crafter_tpu_torch.ops import int8_conv as Q
    g = torch.Generator(device=cuda).manual_seed(C + O)
    x = (3 * torch.randn((N, C, H, W), generator=g, device=cuda)).to(dtype)
    if nhwc:
        x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.randn((O, C, 3, 3), generator=g, device=cuda)
         / (9 * C) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((O,), generator=g, device=cuda)).to(dtype)
    Q.reset_launch_counts()
    with torch.no_grad():
        prod, xs, ws = Q.int8_products(x, w, stride)
        out = Q.int8_conv2d(x, w, b, stride)
    torch.cuda.synchronize()
    assert Q.launches == {"int8_absmax": 2, "int8_quantize": 2,
                          "int8_weight_quant": 2, "int8_conv": 2}
    pref, xsr, wsr = Q.int8_products_reference(x, w, stride)
    assert torch.equal(xs, xsr) and torch.equal(ws, wsr)
    assert torch.equal(prod, pref)
    ref = Q.int8_conv2d_reference(x, w, b, stride)
    assert out.dtype == ref.dtype == dtype and out.shape == ref.shape
    assert out.is_contiguous(memory_format=torch.channels_last if nhwc
                             else torch.contiguous_format)
    if dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        a = out.contiguous().view(torch.int16).int()
        r = ref.contiguous().view(torch.int16).int()
        a = torch.where(a < 0, -32768 - a, a)
        r = torch.where(r < 0, -32768 - r, r)
        assert int((a - r).abs().max()) <= 1


def test_int8_conv_checks_inputs(cuda):
    from street_crafter_tpu_torch.ops import int8_conv as Q
    x = torch.randn(1, 8, 4, 4, device=cuda)
    w = torch.randn(8, 8, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="stride"):
        Q.int8_conv2d(x, w, None, 3)
    with pytest.raises(ValueError, match="3x3"):
        Q.int8_conv2d(x, w[:, :4], None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        Q.int8_conv2d(x.half(), w.half(), None)
    with pytest.raises(RuntimeError, match="eval-only"):
        Q.int8_conv2d(x.requires_grad_(), w, None)

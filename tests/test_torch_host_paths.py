"""Host-side helpers of the port that the card's paths lean on, on the CPU:
the voxel downsample and radius-outlier mask of ``initialize_ply`` against
the JAX package's numpy paths (its native helper switched off, so both run
the reference's semantics), and the host staging of ``Mesh``'s collectives
(gloo with CUDA tensors) against the sums, maxima and broadcasts of the
ranks' inputs. All comparisons are exact: the port sorts, sums and
compares the same float32 and float64 values in the same order."""

import numpy as np
import pytest
import torch

from street_crafter_tpu import native as jax_native
from street_crafter_tpu.utils import ply as jax_ply
from street_crafter_tpu_torch.parallel import mesh as M
from street_crafter_tpu_torch.parallel.mesh import run_ranks
from street_crafter_tpu_torch.utils import ply as P
from tests import torch_dp_ranks


def cloud(kind: str) -> np.ndarray:
    """Point clouds that cover the cell hashing's cases: a dense ground
    plane with a wall (a street's LiDAR), a Gaussian blob with sparse
    tails, points on cell edges, negative and large coordinates, float64,
    one point and none."""
    rng = np.random.default_rng(7)
    if kind == "street":
        g = np.stack([rng.uniform(-5, 25, 40000), rng.uniform(-8, 8, 40000),
                      np.zeros(40000)], -1)
        w = np.stack([rng.uniform(-5, 25, 8000), np.full(8000, 8.0),
                      rng.uniform(0, 4, 8000)], -1)
        return np.concatenate([g, w]).astype(np.float32)
    if kind == "blob":
        return (rng.standard_normal((30000, 3)) * 3).astype(np.float32)
    if kind == "edges":
        return (np.round(rng.uniform(-3, 3, (20000, 3)), 1)).astype(
            np.float32)
    if kind == "far":
        return (rng.standard_normal((5000, 3)) * 1e4 - 5e4).astype(
            np.float32)
    if kind == "float64":
        return rng.standard_normal((8000, 3)) * 2
    if kind == "one":
        return np.array([[0.3, -0.2, 1.0]], np.float32)
    return np.zeros((0, 3), np.float32)


CLOUDS = ("street", "blob", "edges", "far", "float64", "one", "none")


@pytest.fixture
def jax_numpy_paths(monkeypatch):
    """The JAX package's helpers with its native library switched off."""
    monkeypatch.setattr(jax_native, "voxel_downsample", lambda *a: None)
    monkeypatch.setattr(jax_native, "radius_outliers", lambda *a: None)


@pytest.mark.parametrize("kind", CLOUDS)
@pytest.mark.parametrize("voxel", (0.1, 0.7))
def test_voxel_downsample_matches_jax(kind, voxel, jax_numpy_paths):
    pts = cloud(kind)
    cols = np.random.default_rng(1).random(pts.shape).astype(np.float32)
    want = jax_ply.voxel_downsample(pts, cols, voxel)
    got = P.voxel_downsample(pts, cols, voxel)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    no_cols = P.voxel_downsample(pts, None, voxel)
    assert no_cols[1] is None
    np.testing.assert_array_equal(no_cols[0], want[0])


@pytest.mark.parametrize("kind", CLOUDS)
@pytest.mark.parametrize("nb,radius", ((5, 0.5), (10, 0.5), (2, 0.3)))
def test_radius_outliers_match_jax(kind, nb, radius, jax_numpy_paths):
    pts = cloud(kind)
    if kind == "street":          # initialize_ply's order: downsample first
        pts, _ = P.voxel_downsample(pts, None, 0.1)
    want = jax_ply.remove_radius_outliers(pts, nb, radius)
    got = P.remove_radius_outliers(pts, nb, radius)
    assert got.dtype == bool and got.shape == (len(pts),)
    np.testing.assert_array_equal(got, want)


def test_stage_buckets_split_by_dtype_and_size(monkeypatch):
    monkeypatch.setattr(M, "STAGE_BUCKET_BYTES", 64)
    f = [torch.zeros(4) for _ in range(5)]            # 16 bytes each
    big = torch.zeros(100)                             # alone: 400 bytes
    d = torch.zeros(2, dtype=torch.float64)
    i = torch.zeros(3, dtype=torch.int64)
    sizes = [[t.numel() for t in b]
             for b in M._buckets(f + [big, d, i, f[0]])]
    assert sizes == [[4, 4, 4, 4], [4], [100], [2], [3], [4]]


def test_through_host_round_trip():
    """Every tensor, contiguous or not, comes back with the collective's
    result, one call a bucket."""
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    ts = [base[:, ::2], base.T.contiguous(), torch.ones(0),
          torch.arange(5, dtype=torch.int64), torch.full((2, 2), 3.0)]
    want = [2 * t for t in ts]
    calls = []

    def double(h):
        calls.append(h.dtype)
        h.mul_(2)

    M._through_host(ts, double)
    assert calls == [torch.float32, torch.int64, torch.float32]
    for t, w in zip(ts, want):
        torch.testing.assert_close(t, w, rtol=0, atol=0)


def test_staged_collectives_on_two_ranks(tmp_path):
    """Two gloo ranks run all_reduce_ (sum, max) and broadcast_ over a
    list of tensors of three dtypes, one not contiguous, staged through
    host buckets of 64 bytes: each result is the sum, maximum or rank 1's
    value of the ranks' inputs."""
    res = run_ranks(torch_dp_ranks.staged_collectives, 2, str(tmp_path),
                    timeout_s=120)
    for out in res:
        assert set(out) == {"sum", "max", "bcast"}
        for name, (got, want) in out.items():
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=name)

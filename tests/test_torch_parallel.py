"""The port's data-parallel layer (street_crafter_tpu_torch.parallel) on the
CPU: ``MeshSpec.resolve`` and the sharding rules' choice of dim against the
JAX package's, the SPMD bridge's x2 kernel (plain version) against the JAX
Pallas kernel in interpret mode, and two gloo ranks (spawned, ``file://``
rendezvous) running the wrapped x2 on their shards of the leading dim and
the collectives. All comparisons are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.parallel import MeshSpec as JMeshSpec
from street_crafter_tpu.parallel import ShardingRules as JRules
from street_crafter_tpu.parallel import make_virtual_cpu_mesh
from street_crafter_tpu_torch.parallel import kernel_shard as KS
from street_crafter_tpu_torch.parallel.mesh import (Mesh, MeshSpec,
                                                    make_mesh, run_ranks)
from street_crafter_tpu_torch.parallel.sharding import (ShardingRules,
                                                        shard_pytree_batch)
from tests import torch_dp_ranks

RESOLVE_CASES = [({"data": -1, "frames": 1}, 8),
                 ({"data": 2, "frames": 4}, 8), ({"data": 3}, 8),
                 ({"data": -1, "frames": -1}, 8), ({"data": -1}, 1),
                 ({"data": 2}, 1), ({"data": 4, "x": -1}, 8)]


@pytest.mark.parametrize("axes,n", RESOLVE_CASES)
def test_meshspec_resolve_matches_jax(axes, n):
    try:
        want = JMeshSpec(axes).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            MeshSpec(axes).resolve(n)
        return
    assert MeshSpec(axes).resolve(n) == want


def _jax_dim(spec) -> int | None:
    dims = [i for i, a in enumerate(spec) if a == "data"]
    return dims[0] if dims else None


def _leaf_shapes() -> list[tuple]:
    """The tiny UNet's leaves in both layouts (the port's torch shapes, the
    JAX package's flax shapes) and the full-width UNet's torch shapes."""
    from street_crafter_tpu.models.vdm.engine import (
        EngineConfig as JEngineConfig, VideoDiffusionEngine as JEngine)
    from street_crafter_tpu_torch.models.vdm.unet import (UNetConfig,
                                                          VideoUNet)
    jeng = JEngine(JEngineConfig.tiny(num_frames=2))
    tree = jax.eval_shape(lambda k: jeng.init_params(k, 32, 32),
                          jax.random.PRNGKey(0))
    shapes = {tuple(x.shape) for x in jax.tree.leaves(tree["unet"])}
    with torch.device("meta"):
        tiny = VideoUNet(UNetConfig.tiny())
        full = VideoUNet(UNetConfig())
    shapes |= {tuple(p.shape) for p in tiny.parameters()}
    real = [tuple(p.shape) for p in full.parameters()]
    return sorted(shapes | set(real)), real


@pytest.fixture(scope="module")
def leaf_shapes():
    return _leaf_shapes()


@pytest.mark.parametrize("data", [2, 4, 8])
def test_sharding_rules_choose_jaxs_dim(leaf_shapes, data):
    shapes, real = leaf_shapes
    jmesh = make_virtual_cpu_mesh(data, {"data": data})
    mesh = Mesh(shape={"data": data})
    for fsdp in (False, True):
        jr, pr = JRules(jmesh, fsdp_params=fsdp), \
            ShardingRules(mesh, fsdp_params=fsdp)
        for shape in shapes + [(257, 1280), (1,), (7, 3), ()]:
            leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
            assert pr.opt_state_spec(shape) == \
                _jax_dim(jr.opt_state_spec(leaf).spec), (shape, fsdp)
            assert pr.param_spec(shape) == \
                _jax_dim(jr.param_spec(leaf).spec), (shape, fsdp)
    rules = ShardingRules(mesh)
    total = sum(int(np.prod(s)) for s in real)
    sharded = sum(int(np.prod(s)) for s in real
                  if rules.opt_state_spec(s) is not None)
    assert sharded / total > 0.999, sharded / total
    assert rules.opt_state_spec((257, 1280)) == 1
    # DDP: nothing sharded
    assert ShardingRules(mesh, zero=False).opt_state_spec((64, 64)) is None
    with pytest.raises(ValueError, match="zero"):
        ShardingRules(mesh, fsdp_params=True, zero=False)


@pytest.mark.parametrize("shape", [(4, 8), (4, 16), (16, 32), (8, 4, 16)])
def test_x2_plain_matches_pallas(shape):
    from tests.test_kernel_shard import _impl
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(_impl(jnp.asarray(x.reshape(shape[0], -1))))
    KS.reset_launch_counts()
    got = KS.x2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert KS.launches == {"x2_reference": 1}
    with pytest.raises(TypeError, match="float32"):
        KS.x2(torch.zeros(3, dtype=torch.float64))


def test_bridge_without_context_and_guard():
    """No context (or a context without axes): the identity, as in JAX;
    the raster's guard raises under a context with axes."""
    from street_crafter_tpu_torch.ops import gs_raster as G
    assert KS.wrap_kernel(KS.x2, (2,), 2) is KS.x2
    mesh = Mesh(shape={"data": 2})
    with KS.kernel_sharding(mesh, ()):
        assert KS.wrap_kernel(KS.x2, (2,), 2) is KS.x2
        KS.assert_no_context_axes("ok")
    with KS.kernel_sharding(mesh, ("data", "frames")):
        assert KS.active_kernel_sharding()[1] == ("data",)
        with pytest.raises(ValueError, match="not a batch axis"):
            KS.assert_no_context_axes("gs_raster")
        z = torch.zeros(4)
        with pytest.raises(ValueError, match="not a batch axis"):
            G.rasterize_pixels(z, z, z, z, z, torch.zeros(4, 3), z, z,
                               torch.ones(4, dtype=torch.bool), z, 16, 16)
    assert KS.active_kernel_sharding() is None


def test_one_rank_mesh_is_the_identity():
    mesh = make_mesh({"data": -1, "frames": 1}, device="cpu")
    assert mesh.shape == {"data": 1, "frames": 1} and mesh.backend is None
    x = torch.arange(4.0)
    mesh.all_reduce_([x])
    mesh.broadcast_([x])
    assert mesh.all_gather(x) is x and torch.equal(x, torch.arange(4.0))
    assert mesh.local_slice(4) == slice(0, 4)
    # a frames axis resolves over a group of its size
    # (test_frames_mesh_resolves_with_both_groups); one process has one rank
    with pytest.raises(ValueError, match="device count"):
        make_mesh({"data": 1, "frames": 2}, device="cpu")
    with pytest.raises(ValueError, match="device count"):
        make_mesh({"data": 2}, device="cpu")
    batch = {"a": np.arange(6).reshape(3, 2), "b": [torch.ones(3)]}
    assert shard_pytree_batch(batch, mesh)["a"].shape == (3, 2)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    x = np.arange(8 * 4 * 16, dtype=np.float32).reshape(8, 4, 16)
    return x, run_ranks(torch_dp_ranks.bridge_x2, 2,
                        str(tmp_path_factory.mktemp("rdzv")), x,
                        timeout_s=120)


def test_wrapped_x2_on_two_ranks(two_ranks):
    """JAX's test_wrapped_kernel_leading_axis_sharding on two gloo ranks:
    each rank runs x2 once on its [4, 4, 16] shard, the gather is 2 x."""
    x, res = two_ranks
    for r, out in enumerate(res):
        assert out["rank"] == r and out["world"] == 2
        np.testing.assert_array_equal(out["out"], 2 * x)
        assert out["counts"] == {"x2_reference": 1}
        assert out["identity"]


def test_collectives_on_two_ranks(tmp_path):
    res = run_ranks(torch_dp_ranks.collectives, 2, str(tmp_path),
                    timeout_s=120)
    for out in res:
        np.testing.assert_array_equal(out["sum"], [3.0, 10.0])
        np.testing.assert_array_equal(out["max"], [3.0])
        np.testing.assert_array_equal(out["g0"], [[0.0, 0.0], [1.0, 1.0]])
        np.testing.assert_array_equal(out["g1"], [[0.0, 1.0], [0.0, 1.0]])
        np.testing.assert_array_equal(out["bcast"], [1.0])


def test_frames_mesh_resolves_with_both_groups(tmp_path):
    """``{data: 2, frames: 2}`` over four gloo ranks: the frames axis
    innermost, one process group per axis, each collective over its
    axis's two ranks."""
    from tests import torch_sp_ranks
    res = run_ranks(torch_sp_ranks.mesh_layouts, 4, str(tmp_path),
                    [{"data": 2, "frames": 2}], 4, timeout_s=120)
    for r in (x[0] for x in res):
        i = r["coords"]
        assert r["shape"] == {"data": 2, "frames": 2}
        assert r["rank"] == 2 * i["data"] + i["frames"]
        assert r["groups"] == ["data", "frames"]
        assert r["ranks"]["frames"] == [2 * i["data"], 2 * i["data"] + 1]
        assert r["ranks"]["data"] == [i["frames"], 2 + i["frames"]]
        assert r["frames"]["sum"] == sum(r["ranks"]["frames"])
        assert r["data"]["sum"] == sum(r["ranks"]["data"])


def test_failing_rank_fails_the_call(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(torch_dp_ranks.fail_on_rank_1, 2, str(tmp_path),
                  timeout_s=60)

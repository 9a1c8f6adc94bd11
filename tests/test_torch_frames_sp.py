"""The port's sequence parallelism over the ``frames`` mesh axis
(``parallel/mesh.py``'s two-axis mesh, ``parallel/sequence.py``'s
exchanges, the frames-sharded UNet blocks and loss, and GS training on a
mesh with a frames axis) on the CPU, over spawned gloo ranks.

* The mesh: coordinates, axis ranks and groups for ``{data: 2, frames:
  2}`` and ``{frames: 2, data: 2}`` (the last axis innermost, as JAX's
  ``make_mesh``), each collective over each axis, an uneven all-to-all
  (some parts empty) and its round trip, and ``halo`` at the clip's ends.
* Each autograd exchange (frames to tokens and back, with uneven token
  runs; the halo; the sum over the group; the clip's first frame) on
  ``{frames: 2}`` and ``{frames: 4}``: outputs and gradients equal, to
  1e-6, the whole-tensor autograd of the same function in one process.
* ``VideoResBlock``, ``SpatialVideoTransformer`` and the tiny UNet (f32,
  its default flash0 remat), forward and backward on ``{frames: 2}`` and
  ``{frames: 4}`` (one frame a rank: both halos from neighbours), against
  the port in one process (outputs, input and parameter gradients) and
  against the JAX modules from the same weights (outputs and input
  gradients): atol 2e-5 + rtol 1e-4, for the parameter gradients the
  absolute part times the module's largest parameter gradient (each sums
  B T H W products: measured 4.4e-5 apart on elements of leaves near 20,
  and 4.7e-5 on the mixer's scalar 0.18, a sum with cancellation).
* ``diffusion_loss`` with the additional losses on ``{frames: 2}``: the
  loss, its gradient and the scalars summed over the group equal the whole
  clip's to 1e-6 relative.
* A batch-2 GS run (5 steps, a densify after the third) on ``{data: 2,
  frames: 2}`` against ``{data: 2}``: every leaf within 1e-5 of its
  largest |value|, all four ranks' states bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.vdm import layers as JL
from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu_torch.config import to_dict
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm.engine import EngineConfig
from street_crafter_tpu_torch.parallel.mesh import run_ranks
from tests import torch_sp_ranks as SR
from tests.test_torch_gs_dp import ORDER, _assert_close, _assert_equal, setup
from tests.torch_port_helpers import random_params

B, T = 2, 4
ATOL, RTOL = 2e-5, 1e-4
EXACT = 1e-6
DF, FD = {"data": 2, "frames": 2}, {"frames": 2, "data": 2}
__all__ = ["setup"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad(fn, *args):
    """JAX: fn(*args) and the gradient of sum(fn * R) for R = args[-1]
    with respect to the first argument (one jitted vjp)."""
    @jax.jit
    def both(x, rest, r):
        out, pull = jax.vjp(lambda a: fn(a, *rest), x)
        return out, pull(r)[0]
    out, g = both(args[0], args[1:-1], args[-1])
    return np.asarray(out), np.asarray(g)


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


@pytest.fixture(scope="module")
def cases():
    """The layers' and the tiny UNet's weights (seeded random, carried
    from JAX), inputs, cotangents and JAX's outputs and input
    gradients."""
    rng = np.random.default_rng(3)
    out, jax_ref = {}, {}
    # VideoResBlock: C 32, embedding 16, 4x4
    x = rng.normal(size=(B * T, 4, 4, 32)).astype(np.float32)
    emb = rng.normal(size=(B * T, 16)).astype(np.float32)
    R = rng.normal(size=x.shape).astype(np.float32)
    jmod = JL.VideoResBlock(out_channels=32)
    p = random_params(jax.eval_shape(
        lambda k: jmod.init(k, jnp.asarray(x), jnp.asarray(emb), T),
        jax.random.PRNGKey(1)), 4)
    sd = PCV.state_dict_from_jax({"m": p["params"]},
                                 PCV._resblock_map("m", "m"))
    jax_ref["resblock"] = _grad(lambda a, e: jmod.apply(p, a, e, T),
                                jnp.asarray(x), jnp.asarray(emb),
                                jnp.asarray(R))
    out["resblock"] = dict(T=T, C=32, emb=16, grad_of=("x", "emb"),
                           sd={k[2:]: v.numpy() for k, v in sd.items()},
                           inputs={"x": _nchw(x), "emb": emb},
                           R=_nchw(R))
    # SpatialVideoTransformer: C 64, 4 heads of 16, 4x8 tokens
    x = rng.normal(size=(B * T, 4, 8, 64)).astype(np.float32)
    ctx = rng.normal(size=(B * T, 1, 48)).astype(np.float32)
    ctx = np.repeat(ctx[::T], T, axis=0)      # the UNet's per-clip context
    R = rng.normal(size=x.shape).astype(np.float32)
    jmod2 = JL.SpatialVideoTransformer(heads=4, dim_head=16, depth=1,
                                       context_dim=48)
    p2 = random_params(jax.eval_shape(
        lambda k: jmod2.init(k, jnp.asarray(x), jnp.asarray(ctx), T),
        jax.random.PRNGKey(2)), 5)
    sd = PCV.state_dict_from_jax({"m": p2["params"]},
                                 PCV._transformer_map("m", "m", 1, False))
    jax_ref["svt"] = _grad(lambda a, c: jmod2.apply(p2, a, c, T),
                           jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(R))
    out["svt"] = dict(T=T, C=64, heads=4, dh=16, grad_of=("x",),
                      sd={k[2:]: v.numpy() for k, v in sd.items()},
                      inputs={"x": _nchw(x), "ctx": ctx}, R=_nchw(R))
    # the tiny UNet
    jeng = JEngine(JEngineConfig.tiny(num_frames=T))
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, 32, 32), jax.random.PRNGKey(0)), 6)
    sd = PCV.engine_params_from_jax(params, EngineConfig.tiny(num_frames=T))
    ins = {"x": rng.normal(size=(B * T, 16, 16, 8)),
           "t": rng.normal(size=(B * T,)),
           "ctx": ("per_clip", rng.normal(size=(B, 1, 48))),
           "y": ("per_clip", rng.normal(size=(B, 24))),
           "cm": np.array([1, 0, 0, 0, 1, 1, 0, 0]),
           "g": rng.normal(size=(B * T, 16, 16, 4)),
           "gs": np.array([0, 0, 0, 0, 1, 1, 1, 1])}
    ins = {k: (v[0], v[1].astype(np.float32)) if isinstance(v, tuple)
           else v.astype(np.float32) for k, v in ins.items()}
    R = rng.normal(size=(B * T, 16, 16, 4)).astype(np.float32)
    a = {k: jnp.asarray(v[1] if isinstance(v, tuple) else v)
         for k, v in ins.items()}
    jax_ref["unet"] = _grad(
        lambda xx: jeng.unet.apply(params["unet"], xx, a["t"], a["ctx"],
                                   a["y"], num_frames=T, cond_mask=a["cm"],
                                   guidance_input=a["g"],
                                   guidance_scale=a["gs"]),
        a["x"], jnp.asarray(R))
    out["unet"] = dict(T=T, grad_of=("x",), inputs=ins, R=R,
                       sd={k: v.numpy() for k, v in sd["unet"].items()})
    return out, jax_ref


def _x(seed, S):
    return np.random.default_rng(seed).normal(
        size=(B, T, S, 3)).astype(np.float32)


def _cotangents(seed, S):
    rng = np.random.default_rng(seed)
    r = {k: rng.normal(size=(B, T, S, 3)).astype(np.float32)
         for k in ("to_tokens", "to_frames", "sum", "first")}
    r["halo"] = rng.normal(size=(B, T + 2, S, 3)).astype(np.float32)
    return r


def _loss_args():
    rng = np.random.default_rng(9)
    lat = rng.normal(size=(B, T, 8, 8, 4)).astype(np.float32)
    draws = (rng.normal(size=(B,)).astype(np.float32),
             np.array([1, 0, 0, 0, 1, 1, 0, 0], np.float32),
             rng.normal(size=(B * T, 8, 8, 4)).astype(np.float32),
             rng.normal(size=(B * T, 4)).astype(np.float32))
    return lat, draws, 0.7


# token counts: 48 = 3 tiles at f = 2 (32 / 16 tokens), 18 at f = 4 (5, 5,
# 4, 4 tokens)
S_OF = {2: 48, 4: 18}


@pytest.fixture(scope="module")
def runs(cases, setup, tmp_path_factory):
    c, _ = cases
    s = setup
    gs_args = (to_dict(s["pcfg"]), s["state0"], s["cams"], s["targets"],
               ORDER, 2, 1e-7)
    tmp = str(tmp_path_factory.mktemp("frames_sp"))
    one = {"layers": SR.layer_cases(None, None, c),
           "loss": SR.sharded_loss(None, None, *_loss_args())}
    four = run_ranks(SR.suite, 4, tmp, [
        ("mesh", "mesh_layouts", ([DF, FD], T)),
        ("ex", "exchanges", ({"frames": 4}, _x(1, S_OF[4]),
                             _cotangents(2, S_OF[4]))),
        ("layers", "layer_cases", ({"frames": 4}, c)),
        ("gs", "gs_steps_on", (DF,) + gs_args)], timeout_s=300)
    two = run_ranks(SR.suite, 2, tmp, [
        ("ex", "exchanges", ({"frames": 2}, _x(3, S_OF[2]),
                             _cotangents(4, S_OF[2]))),
        ("layers", "layer_cases", ({"frames": 2}, c)),
        ("loss", "sharded_loss", ({"frames": 2},) + _loss_args()),
        ("gs", "gs_steps_on", ({"data": 2},) + gs_args)], timeout_s=300)
    return {"one": one, 2: two, 4: four}


def test_mesh_layouts(runs):
    for k, spec in enumerate((DF, FD)):
        res = [r["mesh"][k] for r in runs[4]]
        inner = list(spec)[-1]
        for r in res:
            assert r["shape"] == spec
            i = r["coords"]
            # the last axis innermost
            want = (i["data"] * 2 + i["frames"] if inner == "frames"
                    else i["frames"] * 2 + i["data"])
            assert r["rank"] == want
            assert r["groups"] == ["data", "frames"]
            for axis in ("data", "frames"):
                ranks = r["ranks"][axis]
                assert r["rank"] in ranks and len(ranks) == 2
                assert [res[q]["coords"][axis] for q in ranks] == [0, 1]
                other = "frames" if axis == "data" else "data"
                assert len({res[q]["coords"][other] for q in ranks}) == 1
                assert r[axis]["sum"] == sum(ranks)
                assert r[axis]["max"] == max(ranks)
                assert r[axis]["bcast"] == ranks[1]
                assert r[axis]["gather"] == [float(q) for q in ranks]
        for r in res:
            i, fr = r["coords"]["frames"], r["ranks"]["frames"]
            assert r["a2a_back"]
            for k2, got in enumerate(r["a2a"]):
                np.testing.assert_array_equal(
                    got, np.full((k2 + 1) * (i + 2), 100.0 * fr[k2] + i))
            base = np.arange(T) + 100.0 * r["coords"]["data"]
            padded = np.concatenate([[0.0], base, [0.0]])
            sl = r["frames_slice"]
            np.testing.assert_array_equal(
                r["halo"], padded[sl.start:sl.stop + 2])


def _whole_exchanges(X, R, f):
    """The exchanges' functions on the whole clip, by torch autograd in
    this process, each rank's loss against its part of R: the halo's
    windows overlap, the group's sum is of the f ranks' [B, T/f, ...])."""
    out = {}
    x = torch.tensor(X, requires_grad=True)
    (x * torch.tensor(R["to_tokens"])).sum().backward()
    out["to_tokens"] = (X, x.grad.numpy())
    x = torch.tensor(X, requires_grad=True)
    (x * torch.tensor(R["to_frames"])).sum().backward()
    out["to_frames"] = (X, x.grad.numpy())
    x = torch.tensor(X, requires_grad=True)
    h = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    r = torch.tensor(R["halo"])
    L = T // f
    sum((h[:, i * L:i * L + L + 2] * r[:, i * L:i * L + L + 2]).sum()
        for i in range(f)).backward()
    out["halo"] = (h.detach().numpy(), x.grad.numpy())
    x = torch.tensor(X, requires_grad=True)
    s = x.reshape(B, f, T // f, *X.shape[2:]).sum(1)
    (s[:, None] * torch.tensor(R["sum"]).reshape(B, f, T // f,
                                                 *X.shape[2:])
     ).sum().backward()
    out["sum"] = (s.detach().numpy(), x.grad.numpy())
    x = torch.tensor(X, requires_grad=True)
    c = x[:, 0]
    (c[:, None] * torch.tensor(R["first"])[:, ::T // f]).sum().backward()
    out["first"] = (c.detach().numpy(), x.grad.numpy())
    return out


@pytest.mark.parametrize("f,xs,rs", [(2, 3, 4), (4, 1, 2)])
def test_exchange_gradients(runs, f, xs, rs):
    S = S_OF[f]
    X, R = _x(xs, S), _cotangents(rs, S)
    want = _whole_exchanges(X, R, f)
    L = T // f
    for i, r in enumerate(runs[f]):
        ex = r["ex"]
        runs_ = ex["runs"]
        assert sum(runs_) == S and len(set(runs_)) == 2   # uneven runs
        run = slice(sum(runs_[:i]), sum(runs_[:i + 1]))
        fr = slice(i * L, (i + 1) * L)
        y, g = ex["to_tokens"]
        np.testing.assert_allclose(y.reshape(B, T, -1, 3), X[:, :, run],
                                   atol=EXACT)
        np.testing.assert_allclose(g.reshape(B, L, S, 3),
                                   want["to_tokens"][1][:, fr], atol=EXACT)
        y, g = ex["to_frames"]
        np.testing.assert_allclose(y.reshape(B, L, S, 3), X[:, fr],
                                   atol=EXACT)
        np.testing.assert_allclose(g.reshape(B, T, -1, 3),
                                   want["to_frames"][1][:, :, run],
                                   atol=EXACT)
        h, g = ex["halo"]
        np.testing.assert_allclose(h, want["halo"][0][:, i * L:i * L + L + 2],
                                   atol=EXACT)
        np.testing.assert_allclose(g, want["halo"][1][:, fr], atol=EXACT)
        s, g = ex["sum"]
        np.testing.assert_allclose(s, want["sum"][0], atol=EXACT)
        np.testing.assert_allclose(g, want["sum"][1][:, fr], atol=EXACT)
        c, g = ex["first"]
        np.testing.assert_allclose(c, want["first"][0], atol=EXACT)
        np.testing.assert_allclose(g.reshape(B, L, S, 3),
                                   want["first"][1][:, fr], atol=EXACT)


def _frames_of(a, f, i):
    L = T // f
    a = a.reshape(B, T, *a.shape[1:])[:, i * L:(i + 1) * L]
    return a.reshape(-1, *a.shape[2:])


@pytest.mark.parametrize("name", ["resblock", "svt", "unet"])
@pytest.mark.parametrize("f", [2, 4])
def test_layers_match_one_process_and_jax(runs, cases, name, f):
    _, jax_ref = cases
    one = runs["one"]["layers"][name]
    j_out, j_dx = jax_ref[name]
    nhwc = name != "unet"           # the layers' port outputs are NCHW
    for i, r in enumerate(runs[f]):
        got = r["layers"][name]
        out = got["out"]
        np.testing.assert_allclose(out, _frames_of(one["out"], f, i),
                                   atol=ATOL, rtol=RTOL)
        jo = _frames_of(j_out, f, i)
        np.testing.assert_allclose(np.moveaxis(out, 1, -1) if nhwc else out,
                                   jo, atol=ATOL, rtol=RTOL)
        for k, g in got["inputs"].items():
            np.testing.assert_allclose(g, _frames_of(one["inputs"][k], f, i),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
        dx = got["inputs"]["x"]
        np.testing.assert_allclose(np.moveaxis(dx, 1, -1) if nhwc else dx,
                                   _frames_of(j_dx, f, i), atol=ATOL,
                                   rtol=RTOL)
        # a parameter's gradient sums B T H W products, with cancellation
        # for the mixer's scalar: the absolute tolerance scales with the
        # module's largest parameter gradient
        top = max(float(np.abs(w).max()) for w in one["params"].values())
        for n, g in got["params"].items():
            np.testing.assert_allclose(g, one["params"][n],
                                       atol=ATOL * max(1.0, top), rtol=RTOL,
                                       err_msg=n)


def test_sharded_loss_matches_whole_clip(runs):
    want = runs["one"]["loss"]
    assert set(want["scalars"]) == {"loss", "hf_loss", "sigma_mean"}
    for r in runs[2]:
        got = r["loss"]
        assert got["loss"] == pytest.approx(want["loss"], rel=EXACT)
        assert got["dw"] == pytest.approx(want["dw"], rel=EXACT)
        for k, v in want["scalars"].items():
            assert got["scalars"][k] == pytest.approx(v, rel=EXACT), k


def test_gs_batch_on_data_and_frames(runs):
    """Cameras split over data and replicated over frames: the {data: 2,
    frames: 2} run is the {data: 2} run."""
    four = [r["gs"] for r in runs[4]]
    two = [r["gs"] for r in runs[2]]
    for r in four[1:]:
        _assert_equal(r["state"], four[0]["state"])
    assert four[0]["n_valid"] == two[0]["n_valid"]
    assert four[0]["n_valid"][0][1] > four[0]["n_valid"][0][0]
    np.testing.assert_allclose(four[0]["losses"], two[0]["losses"],
                               rtol=1e-5)
    _assert_close(four[0]["state"], two[0]["state"])

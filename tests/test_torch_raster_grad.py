"""Port parity for the compositing backward (kernel C's plain version, the
path CPU tensors take): ``rasterize_pixels``' gradients w.r.t. u, v, the
conic, colours, opacities and the absgrad sink against three references on
the same numpy inputs:

- the JAX package's trainable raster (``rasterize_pixels_trainable``, K3
  itself, in interpret mode as tests/test_gs_raster_train.py runs it);
- the JAX XLA autodiff oracle (``rasterize_pixels``, exact selection,
  capacities >= N);
- torch.autograd through the port's plain forward ``composite_reference``.

The scenes keep opacities <= 0.5 with few layers, so T never reaches 1e-4:
the port's stop rule and the JAX paths' full walks then composite the same
pairs (asserted below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.ops.gs_raster import rasterize_pixels as j_raster
from street_crafter_tpu.ops.gs_raster_train import rasterize_pixels_trainable
from street_crafter_tpu_torch.ops import gs_raster as G
from raster_cases import adversarial_cull_splats  # tests/raster_cases.py

W, H, N = 128, 64, 200
NAMES = ["u", "v", "conic_a", "conic_b", "conic_c", "colors", "opacities",
         "absgrad"]


def scene(seed, wide=0.0):
    """Positive-definite conics with varied anisotropy, opacity <= 0.5,
    depth as a fourth channel."""
    rng = np.random.default_rng(seed)
    s1 = rng.uniform(2.0, 9.0, N)
    s2 = rng.uniform(2.0, 9.0, N)
    k = int(wide * N)
    s1[:k] = rng.uniform(15.0, 30.0, k)
    th = rng.uniform(0, np.pi, N)
    ct, st = np.cos(th), np.sin(th)
    a = ct ** 2 / s1 ** 2 + st ** 2 / s2 ** 2
    c = st ** 2 / s1 ** 2 + ct ** 2 / s2 ** 2
    b = ct * st * (1 / s1 ** 2 - 1 / s2 ** 2)
    depth = rng.uniform(1, 50, N)
    colors = np.concatenate([rng.uniform(0, 1, (N, 3)), depth[:, None] / 50],
                            1)
    f32 = np.float32
    return dict(u=rng.uniform(-10, W + 10, N).astype(f32),
                v=rng.uniform(-10, H + 10, N).astype(f32),
                conic_a=a.astype(f32), conic_b=b.astype(f32),
                conic_c=c.astype(f32), colors=colors.astype(f32),
                opacities=rng.uniform(0.05, 0.5, N).astype(f32),
                depths=depth.astype(f32), valid=np.ones(N, bool),
                radii=np.ceil(3.0 * np.maximum(s1, s2)).astype(f32))


def cotangents(seed):
    rng = np.random.default_rng(seed + 100)
    return (rng.normal(size=(H, W, 4)).astype(np.float32),
            rng.normal(size=(H, W)).astype(np.float32))


DIFF = ["u", "v", "conic_a", "conic_b", "conic_c", "colors", "opacities"]


def port_grads(s, gcol, gal):
    leaves = {k: torch.tensor(s[k], requires_grad=True) for k in DIFF}
    sink = torch.zeros((N, 2), requires_grad=True)
    out = G.rasterize_pixels(**leaves, depths=torch.tensor(s["depths"]),
                             valid=torch.tensor(s["valid"]),
                             radii=torch.tensor(s["radii"]), width=W,
                             height=H, absgrad_sink=sink)
    loss = ((out.colors * torch.tensor(gcol)).sum()
            + (out.alpha * torch.tensor(gal)).sum())
    loss.backward()
    return (float(loss.detach()), [leaves[k].grad.numpy() for k in DIFF]
            + [sink.grad.numpy()], out)


def jax_grads(fn, s, gcol, gal, **kw):
    def f(u, v, a, b, c, colors, opa, sink):
        out = fn(u, v, a, b, c, colors, opa, jnp.asarray(s["depths"]),
                 jnp.asarray(s["valid"]), jnp.asarray(s["radii"]),
                 absgrad_sink=sink, width=W, height=H, **kw)
        return jnp.sum(out.colors * gcol) + jnp.sum(out.alpha * gal)
    args = [jnp.asarray(s[k]) for k in DIFF] + [jnp.zeros((N, 2))]
    val, g = jax.value_and_grad(f, argnums=tuple(range(8)))(*args)
    return float(val), [np.asarray(x) for x in g]


def rel_err(got, want):
    scale = np.abs(want).max() + 1e-12
    return np.abs(got - want) / scale


@pytest.mark.parametrize("seed,wide", [(0, 0.0), (1, 0.1)])
def test_backward_matches_jax_xla_oracle(seed, wide):
    s = scene(seed, wide)
    gcol, gal = cotangents(seed)
    val, got, out = port_grads(s, gcol, gal)
    # the port never stopped a pixel: its pairs are the oracle's
    assert float(out.alpha.max()) < 1 - 1e-4 * 10
    ref_val, want = jax_grads(j_raster, s, gcol, gal, exact_select=True,
                              max_per_tile=N, max_per_coarse=N)
    assert val == pytest.approx(ref_val, rel=1e-5)
    # both evaluate sigma = 0.5 (a dx^2 + c dy^2) + b dx dy in global pixel
    # coordinates and gate alike; only the sums over pixels run in another
    # order (measured: 2.6e-7 and 1.1e-6 of the field's largest gradient)
    for name, g, r in zip(NAMES, got, want):
        e = rel_err(g, r)
        assert e.max() < 2e-5, (name, e.max())
    assert got[-1].max() > 0      # the absgrad sink is non-trivial


def test_backward_matches_jax_trainable_kernel():
    s = scene(2, 0.05)
    gcol, gal = cotangents(2)
    val, got, _ = port_grads(s, gcol, gal)
    ref_val, want = jax_grads(rasterize_pixels_trainable, s, gcol, gal,
                              select_method="exact", max_per_coarse=256,
                              max_per_row=256)
    _, oracle = jax_grads(j_raster, s, gcol, gal, exact_select=True,
                          max_per_tile=N, max_per_coarse=N)
    # K3 differs from the XLA oracle by itself: it gates on log alpha >=
    # -5.545 (alpha >= 3.909e-3, not 1/255 = 3.922e-3) and evaluates sigma
    # in tile-local Cholesky form. The port must sit no farther from K3
    # than the oracle does, plus the port-oracle bound of the test above;
    # and within K3's own test bounds against the oracle, widened for this
    # scene's measured max (conic_b 2.02e-2 from K3 against both)
    assert val == pytest.approx(ref_val, rel=3e-3)
    for name, g, r, o in zip(NAMES, got, want, oracle):
        e = rel_err(g, r)
        assert e.max() <= rel_err(o, r).max() + 2e-3, (name, e.max())
        assert e.max() < 3e-2, (name, e.max())
        assert np.quantile(e, 0.95) < 2e-3, (name, np.quantile(e, 0.95))


@pytest.mark.parametrize("seed", [3, 4])
def test_backward_matches_autograd_of_plain_forward(seed):
    """Same formulas, same gates and T from the same cumprod: every field
    but absgrad (autograd has no |.| channel) to float rounding. Opacities
    up to 0.99 here, so the stop rule and the 0.999 clamp act."""
    s = scene(seed, 0.1)
    s["opacities"] = np.random.default_rng(seed).uniform(
        0.3, 0.99, N).astype(np.float32)
    gcol, gal = cotangents(seed)
    _, got, out = port_grads(s, gcol, gal)
    assert float(out.alpha.max()) > 0.999   # some pixels stopped
    leaves = {k: torch.tensor(s[k], requires_grad=True) for k in DIFF}
    wl = G.tile_worklist_reference(
        leaves["u"], leaves["v"], torch.tensor(s["radii"]),
        torch.tensor(s["depths"]), torch.tensor(s["valid"]), W, H)
    col, alpha = G.composite_reference(wl, *(leaves[k] for k in DIFF), W, H)
    ((col * torch.tensor(gcol)).sum()
     + (alpha * torch.tensor(gal)).sum()).backward()
    for name, g in zip(DIFF, got):
        e = rel_err(g, leaves[name].grad.numpy())
        # f32: the suffix sums of the adjoint vs autograd's chain of
        # cumprod/where backward
        assert e.max() < 1e-5, (name, e.max())
    # sum |du| over pixels bounds |sum du|
    assert (got[-1][:, 0] >= np.abs(got[0]) * (1 - 1e-5) - 1e-7).all()
    assert (got[-1][:, 1] >= np.abs(got[1]) * (1 - 1e-5) - 1e-7).all()


def test_raster_autograd_routing_and_hooks():
    """The viewspace-zero contract (d/dvz == d/d(u, v)), launch counts of
    the plain versions, and no autograd graph without a leaf that needs
    one."""
    s = scene(5)
    t = {k: torch.tensor(x) for k, x in s.items()}
    G.reset_launch_counts()
    out = G.rasterize_pixels(**t, width=W, height=H)
    assert not out.colors.requires_grad
    assert dict(G.launches) == {"tile_worklist_reference": 1,
                                "composite_reference": 1}
    vz = torch.zeros((N, 2), requires_grad=True)
    u = torch.tensor(s["u"], requires_grad=True)
    v = torch.tensor(s["v"], requires_grad=True)
    out = G.rasterize_pixels(**dict(t, u=u + vz[:, 0], v=v + vz[:, 1]),
                             width=W, height=H)
    out.colors.sum().backward()
    assert torch.equal(vz.grad[:, 0], u.grad)
    assert torch.equal(vz.grad[:, 1], v.grad)
    assert G.launches["composite_backward_reference"] == 1
    # training variant of the plain forward: T and the last contributor
    wl = G.tile_worklist_reference(t["u"], t["v"], t["radii"], t["depths"],
                                   t["valid"], W, H)
    comp = [t[k] for k in DIFF]
    col, alpha, final_T, last = G.composite_reference(wl, *comp, W, H,
                                                      train=True)
    torch.testing.assert_close(alpha, 1.0 - final_T, atol=0, rtol=0)
    assert int(last.max()) > 0 and int(last.min()) >= 0
    assert torch.equal(last > 0, alpha > 0)


@pytest.mark.parametrize("kind,seed", [("scene", 3), ("scene", 4),
                                       ("adversarial", 0)])
def test_warp_cull_leaves_backward_unchanged(kind, seed):
    """The plain backward with the pairs of the per-warp cull (kernels B
    and C skip them) forced to alpha 0 is bit-equal to the plain backward:
    the cull removes only pairs that no pixel of the warp takes. Opacities
    up to 0.99 in the scenes, so the stop rule and the 0.999 clamp act."""
    if kind == "scene":
        s = scene(seed, 0.1)
        s["opacities"] = np.random.default_rng(seed).uniform(
            0.3, 0.99, N).astype(np.float32)
        w, h = W, H
    else:
        w, h = 64, 48
        s = adversarial_cull_splats(w, h, seed)
    t = {k: torch.tensor(x) for k, x in s.items()}
    rng = np.random.default_rng(seed + 200)
    gcol = torch.tensor(rng.normal(size=(h, w, 4)), dtype=torch.float32)
    gal = torch.tensor(rng.normal(size=(h, w)), dtype=torch.float32)
    wl = G.tile_worklist_reference(t["u"], t["v"], t["radii"], t["depths"],
                                   t["valid"], w, h)
    comp = [t[k] for k in DIFF]
    cull = G.warp_cull_reference(wl, *comp[:5], t["opacities"], w)
    assert bool(cull.any()) and not bool(cull.all())
    plain = G.composite_backward_reference(wl, *comp, w, h, gcol, gal)
    culled = G.composite_backward_reference(wl, *comp, w, h, gcol, gal,
                                            cull=cull)
    assert bool(plain.abs().sum() > 0)
    assert torch.equal(plain, culled)

"""Port parity for the training operators of street_crafter_tpu_torch: SSIM,
PSNR, L1/L2, LPIPS and every loss term, per-group Adam, densify/prune and
the opacity reset, each against the JAX package on the same numpy inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.gs import densify as jd
from street_crafter_tpu.models.gs import losses as jl
from street_crafter_tpu.models.gs import optim as jo
from street_crafter_tpu.models.gs.params import GaussianPool as JPool
from street_crafter_tpu.ops import lpips as jlp
from street_crafter_tpu.ops import ssim as js
from street_crafter_tpu_torch.models.gs import densify as td
from street_crafter_tpu_torch.models.gs import losses as tl
from street_crafter_tpu_torch.models.gs import optim as to
from street_crafter_tpu_torch.models.gs.params import GaussianPool as TPool
from street_crafter_tpu_torch.ops import lpips as tlp
from street_crafter_tpu_torch.ops import ssim as ts

H, W = 40, 56


def images(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = (rng.random((H, W, 1)) > 0.3).astype(np.float32)
    return a, b, mask


def t(x):
    return torch.tensor(np.asarray(x))


# f32 sums in another order (separable conv vs shift-adds, torch vs XLA
# reductions): a few ulps of values near 1
ATOL = 2e-6


@pytest.mark.parametrize("masked", [False, True])
def test_ssim_psnr_l1_l2(masked):
    a, b, mask = images(0)
    jm = jnp.asarray(mask) if masked else None
    tm = t(mask) if masked else None
    for jf, tf in ((js.ssim, ts.ssim), (js.psnr, ts.psnr),
                   (js.l1_loss, ts.l1_loss), (js.l2_loss, ts.l2_loss)):
        want = float(jf(jnp.asarray(a), jnp.asarray(b), mask=jm))
        got = float(tf(t(a), t(b), mask=tm))
        # PSNR is a log: compare in dB at 1e-5 relative
        assert got == pytest.approx(want, abs=ATOL, rel=1e-5), jf.__name__
    # a full-size [H, W, 1] mask (the other masked-mean branch)
    full = np.repeat(mask, 3, -1)
    assert float(ts.l1_loss(t(a), t(b), t(full))) == pytest.approx(
        float(js.l1_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(full))),
        abs=ATOL)


@pytest.fixture(scope="module")
def lpips_params():
    """The JAX package's random-weight LPIPS, carried across as numpy."""
    return {k: np.asarray(v) for k, v in
            jlp.random_lpips_params(jax.random.PRNGKey(0)).items()}


def test_lpips_matches_jax(lpips_params, tmp_path):
    a, b, _ = images(1)
    want = float(jlp.lpips_distance(lpips_params, jnp.asarray(a),
                                    jnp.asarray(b)))
    got = float(tlp.lpips_distance(lpips_params, t(a), t(b)))
    # 13 f32 convolutions deep: relative 1e-4 (XLA's and torch's conv
    # accumulate in another order)
    assert got == pytest.approx(want, rel=1e-4)
    batch = float(tlp.lpips_distance(lpips_params, t(np.stack([a, b])),
                                     t(np.stack([b, a]))))
    assert batch == pytest.approx(got, rel=1e-5)
    # npz format: save, load, and the torch-state-dict converter
    tlp.save_lpips(str(tmp_path / "w.npz"), lpips_params)
    fn = tlp.load_lpips(str(tmp_path / "w.npz"))
    assert float(fn(t(a), t(b))) == pytest.approx(got, rel=1e-6)
    assert tlp.load_lpips(str(tmp_path / "missing.npz")) is None
    rng = np.random.default_rng(0)
    vgg, cin, layer = {}, 3, 0
    for cout, pool in jlp._VGG16:
        layer += 1 if pool else 0
        vgg[f"features.{layer}.weight"] = rng.normal(size=(cout, cin, 3, 3))
        vgg[f"features.{layer}.bias"] = rng.normal(size=(cout,))
        layer += 2
        cin = cout
    lin = {f"lin{i}.model.1.weight": rng.random((1, c, 1, 1))
           for i, c in enumerate([64, 128, 256, 512, 512])}
    mine = tlp.convert_lpips_torch(vgg, lin)
    ref = jlp.convert_lpips_torch(vgg, lin)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))
    # the seeded stand-in: VGG16 shapes, deterministic per seed
    p = tlp.random_lpips_params(torch.Generator().manual_seed(3))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: v.shape for k, v in lpips_params.items()}
    f0, f1 = tlp.random_feature_lpips(0), tlp.random_feature_lpips(0)
    assert float(f0(t(a), t(b))) == float(f1(t(a), t(b))) > 0


def render_out(seed):
    rng = np.random.default_rng(seed)
    rgb, gt, mask = images(seed)
    depth = rng.uniform(1, 30, (H, W)).astype(np.float32)
    lidar = np.where(rng.random((H, W)) > 0.6,
                     depth + rng.normal(0, 2, (H, W)), 0).astype(np.float32)
    lidar[:3, :3] = 500.0     # outliers the best-95% rule drops
    out = {"rgb": rgb, "acc": rng.uniform(0, 1, (H, W)).astype(np.float32),
           "depth": depth}
    batch = {"gt_image": gt, "mask": mask,
             "sky_mask": rng.random((H, W, 1)) > 0.7,
             "obj_bound": rng.random((H, W, 1)) > 0.8,
             "lidar_depth": lidar[..., None]}
    return out, batch


def test_each_loss_term(lpips_params):
    out, batch = render_out(2)
    rng = np.random.default_rng(3)
    scaling = np.exp(rng.normal(-2, 1, (64, 3))).astype(np.float32)
    valid = rng.random(64) > 0.2
    cc = (np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None]
          + rng.normal(0, 0.05, (4, 3, 4))).astype(np.float32)
    pairs = [
        (jl.sky_entropy_loss, tl.sky_entropy_loss,
         (out["acc"], batch["sky_mask"][..., 0])),
        (jl.obj_acc_entropy_loss, tl.obj_acc_entropy_loss,
         (out["acc"], batch["obj_bound"][..., 0])),
        (jl.lidar_depth_loss, tl.lidar_depth_loss,
         (out["depth"], batch["lidar_depth"][..., 0],
          batch["mask"][..., 0] > 0)),
        (jl.scale_flatten_loss, tl.scale_flatten_loss, (scaling, valid)),
        (jl.color_correction_reg, tl.color_correction_reg, (cc, cc[:2])),
    ]
    for jf, tf, args in pairs:
        want = float(jf(*map(jnp.asarray, args)))
        got = float(tf(*map(t, args)))
        # f32 reductions in another order; the depth loss sums ~900 errors
        # of up to 30 m
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6), jf.__name__
    jfn = lambda a, b: jlp.lpips_distance(lpips_params, a, b)  # noqa: E731
    tfn = lambda a, b: tlp.lpips_distance(lpips_params, a, b)  # noqa: E731
    w = jl.LossWeights(lambda_lpips=0.5, lambda_sky=0.05, lambda_reg=0.1,
                       lambda_depth_lidar=0.01, lambda_scale_flatten=0.3,
                       lambda_color_correction=0.2)
    for novel in (False, True):
        jloss, jsc = jl.compute_train_loss(
            {k: jnp.asarray(v) for k, v in out.items()},
            {k: jnp.asarray(v) for k, v in batch.items()}, w, is_novel=novel,
            lpips_fn=jfn, scene_scaling=jnp.asarray(scaling),
            scene_valid=jnp.asarray(valid), color_corr=jnp.asarray(cc),
            acc_obj=jnp.asarray(out["acc"]))
        tloss, tsc = tl.compute_train_loss(
            {k: t(v) for k, v in out.items()},
            {k: t(v) for k, v in batch.items()},
            tl.LossWeights(*w), is_novel=novel, lpips_fn=tfn,
            scene_scaling=t(scaling), scene_valid=t(valid), color_corr=t(cc),
            acc_obj=t(out["acc"]))
        assert sorted(tsc) == sorted(jsc)
        for k in jsc:
            # LPIPS's 1e-4 (above) carries into every sum that holds it
            assert float(tsc[k]) == pytest.approx(float(jsc[k]), rel=1e-4,
                                                  abs=1e-6), (novel, k)


def test_adam_update_exact():
    rng = np.random.default_rng(4)
    shapes = {"xyz": (2, 50, 3), "opacity": (2, 50, 1)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    mask = rng.random((2, 50)) > 0.3
    lrs = {"xyz": 1.6e-4, "opacity": 0.05}
    jstate = jax.vmap(jo.init_adam)({k: jnp.asarray(v)
                                     for k, v in params.items()})
    tp = {k: t(v) for k, v in params.items()}
    tstate = to.init_adam(tp, (2,))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for i in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jstate = jax.vmap(
            lambda p, g, s, m: jo.adam_update(p, g, s, lrs, update_mask=m))(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            jnp.asarray(mask))
        to.adam_update(tp, {k: t(v) for k, v in grads.items()}, tstate, lrs,
                       update_mask=t(mask))
    for k in shapes:
        # the same f32 operations in the same order
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.m[k].numpy(),
                                   np.asarray(jstate.m[k]), rtol=1e-6)
        np.testing.assert_allclose(tstate.v[k].numpy(),
                                   np.asarray(jstate.v[k]), rtol=1e-6)
    np.testing.assert_array_equal(tstate.count.numpy(), [3, 3])
    sl = rng.random((2, 50)) > 0.5
    js2 = jax.vmap(jo.zero_moments_at)(jstate, jnp.asarray(sl))
    to.zero_moments_at(tstate, t(sl))
    for k in shapes:
        np.testing.assert_array_equal(tstate.m[k].numpy(),
                                      np.asarray(js2.m[k]))


def pool_arrays(rng, cap, n_valid, scale_log=(-5, -1)):
    valid = np.zeros(cap, bool)
    valid[rng.choice(cap, n_valid, replace=False)] = True
    return {"xyz": rng.normal(0, 2, (cap, 3)),
            "features_dc": rng.normal(size=(cap, 1, 3)),
            "features_rest": rng.normal(size=(cap, 3, 3)),
            "scaling": rng.uniform(*scale_log, (cap, 3)),
            "rotation": rng.normal(size=(cap, 4)),
            "opacity": rng.normal(-2, 2, (cap, 1)), "valid": valid}


def densify_inputs(seed, cap=96, n_valid=60):
    rng = np.random.default_rng(seed)
    arrays = {k: (v.astype(np.float32) if v.dtype != bool else v)
              for k, v in pool_arrays(rng, cap, n_valid).items()}
    ds = {"grad_accum": rng.uniform(0, 2e-3, cap),
          "grad_abs_accum": rng.uniform(0, 2e-3, cap),
          "denom": rng.integers(0, 3, cap).astype(np.float64),
          "max_radii2d": rng.uniform(0, 0.3, cap)}
    moments = {k: rng.normal(size=arrays[f].shape).astype(np.float32)
               for k, f in (("xyz", "xyz"), ("f_dc", "features_dc"),
                            ("f_rest", "features_rest"),
                            ("scaling", "scaling"), ("rotation", "rotation"),
                            ("opacity", "opacity"))}
    return arrays, {k: v.astype(np.float32) for k, v in ds.items()}, moments


def jax_noise(key, cap):
    """The split noise densify_and_prune draws from ``key``."""
    k1, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(k1, (2, cap, 3)))


def both_states(arrays, ds, moments, batch=()):
    jpool = JPool(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jadam = jo.GaussianAdamState(
        m={k: jnp.asarray(v) for k, v in moments.items()},
        v={k: jnp.asarray(np.abs(v)) for k, v in moments.items()},
        count=jnp.full(batch, 5, jnp.int32))
    jds = jd.DensifyState(**{k: jnp.asarray(v) for k, v in ds.items()})
    tpool = TPool(**{k: t(v) for k, v in arrays.items()})
    tadam = to.GaussianAdamState(
        m={k: t(v) for k, v in moments.items()},
        v={k: t(np.abs(v)) for k, v in moments.items()},
        count=torch.full(batch, 5, dtype=torch.int32))
    tds = td.DensifyState(**{k: t(v) for k, v in ds.items()})
    return (jpool, jadam, jds), (tpool, tadam, tds)


def assert_same(jres, tpool, tadam, tds, info):
    jpool, jadam, jds, jinfo = jres
    np.testing.assert_array_equal(tpool.valid.numpy(), np.asarray(jpool.valid))
    for k in ("features_dc", "features_rest", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(tpool, k).numpy(),
                                      np.asarray(getattr(jpool, k)))
    # split positions: rotation matrix times scaled noise (an einsum vs
    # XLA's dot) plus the parent; split log-scales: one log
    for k in ("xyz", "scaling"):
        np.testing.assert_allclose(getattr(tpool, k).numpy(),
                                   np.asarray(getattr(jpool, k)),
                                   rtol=1e-6, atol=1e-6)
    for k in jadam.m:
        np.testing.assert_array_equal(tadam.m[k].numpy(),
                                      np.asarray(jadam.m[k]))
        np.testing.assert_array_equal(tadam.v[k].numpy(),
                                      np.asarray(jadam.v[k]))
    for f in dataclasses.fields(jds):
        np.testing.assert_array_equal(getattr(tds, f.name).numpy(),
                                      np.asarray(getattr(jds, f.name)))
    for name in jinfo._fields:
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      np.asarray(getattr(jinfo, name)))


@pytest.mark.parametrize("use_abs,big", [(True, False), (False, True)])
def test_densify_and_prune_bkgd(use_abs, big):
    arrays, ds, moments = densify_inputs(5)
    key = jax.random.PRNGKey(7)
    (jp, ja, jds_), (tp, ta, tds_) = both_states(arrays, ds, moments)
    kw = dict(grad_threshold=6e-4, percent_dense=0.01, extent=20.0,
              min_opacity=0.005, prune_big_points=big, percent_big_ws=0.02,
              max_screen_size=0.2, use_abs=use_abs)
    jres = jd.densify_and_prune(jp, ja, jds_, key, **kw)
    info = td.densify_and_prune(tp, ta, tds_, t(jax_noise(key, 96)), **kw)
    assert int(info.n_cloned) > 0 and int(info.n_split) > 0
    assert int(info.n_pruned) > 0
    assert_same(jres, tp, ta, tds_, info)


def test_densify_and_prune_actors_bbox_and_capacity():
    """Stacked actors: the JAX vmap against the port's batch dimension,
    per-actor thresholds and columns (random-init actors on absgrad and
    the base threshold), the bbox prune, and a pool too full for all its
    children."""
    per = [densify_inputs(s, cap=64, n_valid=n) for s, n in ((8, 40),
                                                              (9, 58))]
    stack = [{k: np.stack([p[i][k] for p in per]) for k in per[0][i]}
             for i in range(3)]
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    bbox = np.array([[6.0, 4.0, 5.0], [np.inf] * 3], np.float32)
    rand_init = np.array([False, True])
    (jp, ja, jds_), (tp, ta, tds_) = both_states(*stack, batch=(2,))

    def dp(pool, adam, ds, k, box, ri):
        return jd.densify_and_prune(
            pool, adam, ds, k, grad_threshold=jnp.where(ri, 6e-4, 1e-3),
            percent_dense=0.01, extent=20.0, min_opacity=0.005, bbox=box,
            use_abs=ri | False)

    jres = jax.vmap(dp)(jp, ja, jds_, keys, jnp.asarray(bbox),
                        jnp.asarray(rand_init))
    noise = np.stack([jax_noise(k, 64) for k in keys])
    info = td.densify_and_prune(
        tp, ta, tds_, t(noise),
        grad_threshold=torch.where(t(rand_init), 6e-4, 1e-3),
        percent_dense=0.01, extent=20.0, min_opacity=0.005, bbox=t(bbox),
        use_abs=t(rand_init))
    assert int(info.n_pruned[0]) > 0          # the box prunes actor 0
    assert_same(jres, tp, ta, tds_, info)


def test_densify_sky_pin_extent_and_reset_opacity():
    arrays, ds, moments = densify_inputs(11)
    arrays["xyz"] = arrays["xyz"] * 6.0       # some inside 2r, some outside
    center, radius = np.array([0.5, -0.2, 0.1], np.float32), np.float32(4.0)
    key = jax.random.PRNGKey(11)
    (jp, ja, jds_), (tp, ta, tds_) = both_states(arrays, ds, moments)
    ext_j = jd.sky_extent(jp, jnp.asarray(radius), 0.01)
    ext_t = td.sky_extent(tp, t(radius), 0.01)
    assert float(ext_t) == pytest.approx(float(ext_j), rel=1e-6)
    kw = dict(grad_threshold=6e-4, percent_dense=0.01, min_opacity=0.005,
              use_abs=True)
    jres = jd.densify_and_prune(jp, ja, jds_, key, extent=ext_j,
                                pin_sphere=(jnp.asarray(center),
                                            jnp.asarray(radius)), **kw)
    info = td.densify_and_prune(tp, ta, tds_, t(jax_noise(key, 96)),
                                extent=ext_t,
                                pin_sphere=(t(center), t(radius)), **kw)
    assert int(info.n_split) > 0
    assert_same(jres, tp, ta, tds_, info)
    jpool, jadam = jd.reset_opacity(jres[0], jres[1])
    td.reset_opacity(tp, ta)
    np.testing.assert_array_equal(tp.opacity.numpy(), np.asarray(jpool.opacity))
    for k in jadam.m:
        np.testing.assert_array_equal(ta.m[k].numpy(), np.asarray(jadam.m[k]))
    # accumulate_stats: the trainer's in-place sums
    st = td.init_densify_state((4,))
    td.accumulate_stats(st, t(np.ones(4, np.float32)),
                        t(np.full(4, 2.0, np.float32)),
                        t(np.array([1, 0, 1, 1], np.float32)),
                        t(np.array([0.1, 0.0, 0.3, 0.2], np.float32)))
    td.accumulate_stats(st, *(t(np.ones(4, np.float32)) for _ in range(3)),
                        t(np.full(4, 0.25, np.float32)))
    np.testing.assert_allclose(st.max_radii2d.numpy(), [0.25, 0.25, 0.3,
                                                        0.25])
    np.testing.assert_allclose(st.grad_abs_accum.numpy(), [3.0] * 4)

"""The port's semantic sidecar (street_crafter_tpu_torch.models.gs.semantic,
``render_flat(extra_channels=)``, densify's ``extra``, the PLY's
``semantic_i``) against the JAX package's, on the CPU: JAX's
``tests/test_semantic.py`` cases held against the port.

Tolerances: activations equal to 1e-6 relative (the one-hot logits
exactly); densify: the same slots, and the carried rows equal (a copy);
the render at K = 3 and K = 19 classes against JAX's exact XLA path: the
semantic composite within 1e-3 of the largest |logit| (the port stops a
pixel before T <= 1e-4 and sums in another order), rgb and acc within 2e-3
(the raster's bound, tests/test_torch_render.py); ``semantic_loss`` within
1e-6 relative on the same logits, and its gradient to the splats' logits
through the render within 1e-3 of the largest (the plain compositing
backward against XLA's autodiff); the PLY's ``semantic_i`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.gs import densify as jd
from street_crafter_tpu.models.gs import semantic as js
from street_crafter_tpu.models.gs.renderer import render_flat as jrender
from street_crafter_tpu.models.gs.scene import FlatGaussians as JFlat
from street_crafter_tpu_torch.models.gs import densify as td
from street_crafter_tpu_torch.models.gs import semantic as ps
from street_crafter_tpu_torch.models.gs.renderer import render_flat
from street_crafter_tpu_torch.models.gs.scene import FlatGaussians
from street_crafter_tpu_torch.ops import gs_raster as G
from tests.test_torch_train_ops import (assert_same, both_states,
                                        densify_inputs, jax_noise, t)

W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_activation_modes():
    labels = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    jf = js.init_semantic(8, 3, labels=jnp.asarray(labels))
    pf = ps.init_semantic(8, 3, labels=torch.tensor(labels))
    assert pf.num_classes == 3
    np.testing.assert_array_equal(pf.get_semantic().numpy(),
                                  np.asarray(jf.get_semantic()))
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(8, 3)).astype(np.float32)
    want = np.asarray(js.SemanticField(jnp.asarray(logits),
                                       mode="probabilities").get_semantic())
    got = ps.SemanticField(torch.tensor(logits),
                           mode="probabilities").get_semantic().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    with pytest.raises(ValueError):
        ps.SemanticField(torch.tensor(logits), mode="other").get_semantic()


def test_densify_carries_semantic():
    """JAX's densify with ``extra`` against the port's (the same noise):
    the same pool, moments and slots, and the logits carried the same
    way (children copy their parent's rows; pruned slots keep theirs)."""
    arrays, ds, moments = densify_inputs(5)
    cap = arrays["xyz"].shape[0]
    logits = np.random.default_rng(6).normal(size=(cap, 19)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    (jp, ja, jds_), (tp, ta, tds_) = both_states(arrays, ds, moments)
    kw = dict(grad_threshold=6e-4, percent_dense=0.01, extent=20.0,
              min_opacity=0.005, prune_big_points=True, percent_big_ws=0.02,
              max_screen_size=0.2)
    *jres, jextra = jd.densify_and_prune(
        jp, ja, jds_, key, extra={"semantic": jnp.asarray(logits)}, **kw)
    sem = t(logits)
    info = td.densify_and_prune(tp, ta, tds_, t(jax_noise(key, cap)),
                                extra={"semantic": sem}, **kw)
    assert int(info.n_cloned) > 0 and int(info.n_split) > 0
    assert int(info.n_pruned) > 0
    assert_same(tuple(jres), tp, ta, tds_, info)
    np.testing.assert_array_equal(sem.numpy(), np.asarray(jextra["semantic"]))
    assert not np.array_equal(sem.numpy(), logits)      # children written
    with pytest.raises(ValueError, match="follow the pool"):
        td.densify_and_prune(tp, ta, tds_, t(jax_noise(key, cap)),
                             extra={"semantic": sem[:-1]}, **kw)


def _soup(K: int, seed: int, n: int = 300):
    """Random splats in front of the camera (opacity <= 0.9) with random
    [n, K] logits: (JAX soup, port soup, logits, camera)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    rng.uniform(3.0, 9.0, n)], 1).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    arrays = dict(xyz=xyz, rotation=rot,
                  scaling=rng.uniform(0.03, 0.25, (n, 3)).astype(np.float32),
                  opacity=rng.uniform(0.05, 0.9, n).astype(np.float32),
                  shs=(rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32),
                  valid=rng.random(n) > 0.05)
    logits = rng.normal(0, 2, (n, K)).astype(np.float32)
    cam = dict(w2c=np.eye(4, dtype=np.float32),
               K=np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]],
                          np.float32),
               center=np.zeros(3, np.float32))
    jflat = JFlat(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pflat = FlatGaussians(**{k: torch.tensor(v) for k, v in arrays.items()})
    return jflat, pflat, logits, cam


def _jax_render(jflat, cam, extra):
    n = jflat.xyz.shape[0]
    return jrender(jflat, jnp.asarray(cam["w2c"]), jnp.asarray(cam["K"]),
                   jnp.asarray(cam["center"]), width=W, height=H,
                   extra_channels=extra, method="xla",
                   select_method="exact", max_per_tile=n, max_per_coarse=n)


@pytest.mark.parametrize("K", [3, 19])
def test_semantic_render_matches_jax(K):
    jflat, pflat, logits, cam = _soup(K, seed=K)
    want = _jax_render(jflat, cam, jnp.asarray(logits))
    got = render_flat(pflat, torch.tensor(cam["w2c"]), torch.tensor(cam["K"]),
                      torch.tensor(cam["center"]), W, H,
                      extra_channels=torch.tensor(logits))
    sem = got["semantic"].numpy()
    assert sem.shape == (H, W, K)
    scale = float(np.abs(logits).max())
    assert np.abs(sem - np.asarray(want["semantic"])).max() <= 1e-3 * scale
    for k in ("rgb", "acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3, rtol=0)
    acc = got["acc"].numpy()
    assert np.abs(sem[acc < 1e-6]).max(initial=0.0) < 1e-6
    assert np.abs(sem).max() > 0.1
    # rgb and depth as without the extra channels
    plain = render_flat(pflat, torch.tensor(cam["w2c"]),
                        torch.tensor(cam["K"]), torch.tensor(cam["center"]),
                        W, H)
    assert "semantic" not in plain
    torch.testing.assert_close(got["rgb"], plain["rgb"], atol=1e-6, rtol=0)


def test_semantic_loss_and_gradient_match_jax():
    K = 19
    jflat, pflat, logits, cam = _soup(K, seed=2)
    labels = np.random.default_rng(3).integers(0, K, (H, W))
    mask = np.random.default_rng(4).random((H, W)) > 0.3
    for lam, m in ((1.0, None), (0.5, mask)):
        rendered = np.random.default_rng(5).normal(size=(H, W, K)).astype(
            np.float32)
        want = float(js.semantic_loss(
            jnp.asarray(rendered), jnp.asarray(labels), lam,
            None if m is None else jnp.asarray(m)))
        got = float(ps.semantic_loss(torch.tensor(rendered),
                                     torch.tensor(labels), lam,
                                     None if m is None else torch.tensor(m)))
        assert got == pytest.approx(want, rel=1e-6)
    assert float(ps.semantic_loss(torch.zeros(H, W, K), torch.tensor(labels),
                                  0.0)) == 0.0

    def jloss(lg):
        out = _jax_render(jflat, cam, lg)
        return js.semantic_loss(out["semantic"], jnp.asarray(labels), 1.0)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    lg = torch.tensor(logits, requires_grad=True)
    out = render_flat(pflat, torch.tensor(cam["w2c"]), torch.tensor(cam["K"]),
                      torch.tensor(cam["center"]), W, H, extra_channels=lg)
    ps.semantic_loss(out["semantic"], torch.tensor(labels), 1.0).backward()
    got = lg.grad.numpy()
    scale = float(np.abs(want).max())
    assert scale > 0 and np.abs(got - want).max() <= 1e-3 * scale


def test_channel_limit():
    """4 + K channels up to MAX_CHANNELS (K = 28); above it the raster
    raises and names the limit, on any device."""
    _, pflat, logits, cam = _soup(G.MAX_CHANNELS - 3, seed=9, n=40)
    args = (torch.tensor(cam["w2c"]), torch.tensor(cam["K"]),
            torch.tensor(cam["center"]), W, H)
    out = render_flat(pflat, *args, extra_channels=torch.tensor(
        logits[:, :G.MAX_CHANNELS - 4]))
    assert out["semantic"].shape == (H, W, G.MAX_CHANNELS - 4)
    with pytest.raises(ValueError, match="MAX_CHANNELS = 32"):
        render_flat(pflat, *args, extra_channels=torch.tensor(logits))


def test_ply_roundtrip_with_semantic(tmp_path):
    """The port writes what JAX reads and reads what JAX writes."""
    from street_crafter_tpu.utils import gs_ply as jply
    from street_crafter_tpu_torch.utils import gs_ply as pply
    arrays, _, _ = densify_inputs(11, cap=16, n_valid=10)
    sem = np.random.default_rng(12).normal(size=(16, 4)).astype(np.float32)
    (jp, _, _), (tp, _, _) = both_states(arrays, *densify_inputs(11, 16,
                                                                 10)[1:])
    valid = arrays["valid"]
    pply.export_gaussians_ply(tmp_path / "p.ply", {"background": tp},
                              semantics={"background": torch.tensor(sem)})
    jply.export_gaussians_ply(tmp_path / "j.ply", {"background": jp},
                              semantics={"background": sem})
    assert (tmp_path / "p.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    pools, sems = pply.import_gaussians_ply(tmp_path / "j.ply", capacity=16,
                                            with_semantics=True)
    got = sems["background"].numpy()
    assert got.shape == (16, 4)
    np.testing.assert_array_equal(got[:valid.sum()], sem[valid])
    assert not got[valid.sum():].any()
    np.testing.assert_array_equal(pools["background"].xyz[:valid.sum()]
                                  .numpy(), arrays["xyz"][valid])
    _, jsems = jply.import_gaussians_ply(tmp_path / "p.ply", capacity=16,
                                         with_semantics=True)
    np.testing.assert_array_equal(jsems["background"], got)
    # without semantics: the plain import, and None for a pool without them
    assert set(pply.import_gaussians_ply(tmp_path / "p.ply")) == \
        {"background"}
    pply.export_gaussians_ply(tmp_path / "n.ply", tp)
    assert pply.import_gaussians_ply(tmp_path / "n.ply",
                                     with_semantics=True)[1] == \
        {"vertex": None}

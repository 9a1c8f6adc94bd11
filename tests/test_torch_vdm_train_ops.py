"""The fine-tune's pieces in street_crafter_tpu_torch against the JAX package
on the CPU, on the same numpy inputs: the attention forward with its
logsumexp and the attention backward (plain versions of kernels D, G and H,
through the port's autograd Function), the EDM sigma sampler, the
V-weighting, the cond-frame choices, the Fourier high-pass, the diffusion
loss with the JAX package's random draws fed in, the lr schedules and the
param-group labels. The JAX Pallas kernels (K4 forward, K5 / K6 backward)
run in interpret mode, as the JAX package's own tests run them.

Tolerances, with their reasons:
  * attention forward, lse and gradients in f32: atol 2e-5, rtol 1e-4, the
    JAX package's own flash tests' tolerance (the same f32 arithmetic summed
    in another order, online against two-pass softmax);
  * sigmas, weights, the high-pass, the loss and its gradients: 1e-5 of the
    largest |value| (f32 sums in another order; the FFT of another
    library);
  * schedules: 1e-6 relative (the same f32 formulas);
  * the cond-frame choices: the same table exactly, and empirical
    frequencies of 4000 seeded draws within 0.03 of the probabilities
    (about four standard deviations);
  * param-group labels: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_crafter_tpu.models.vdm import diffusion as JD
from street_crafter_tpu.models.vdm import loss as JL
from street_crafter_tpu.models.vdm import lr_schedule as JS
from street_crafter_tpu.models.vdm.engine import (EngineConfig as JEngineConfig,
                                                  VideoDiffusionEngine as JEngine)
from street_crafter_tpu.ops import flash_attention as JFA
from street_crafter_tpu.training import vdm_trainer as JT
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm import diffusion as PD
from street_crafter_tpu_torch.models.vdm import loss as PL
from street_crafter_tpu_torch.models.vdm import lr_schedule as PS
from street_crafter_tpu_torch.models.vdm.unet import UNetConfig
from street_crafter_tpu_torch.ops import flash_attention as PFA
from street_crafter_tpu_torch.training import vdm_trainer as PT

ATOL, RTOL = 2e-5, 1e-4
REL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    """Run pallas kernels interpreted on the CPU."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _qkv(rng, b, sq, skv, h, d):
    return [rng.normal(size=(b, n, h, d)).astype(np.float32)
            for n in (sq, skv, skv, sq)]


SHAPES = [(1, 100, 75, 2, 64), (2, 128, 128, 3, 64), (1, 75, 100, 1, 64)]


@pytest.mark.parametrize("b,sq,skv,h,d", SHAPES)
def test_flash_forward_lse_matches_jax(interpret, b, sq, skv, h, d):
    q, k, v, _ = _qkv(np.random.default_rng(sq + skv), b, sq, skv, h, d)

    def bhsd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
            b * h, x.shape[1], d)
    jo, jlse = JFA._flash_forward(bhsd(q), bhsd(k), bhsd(v))
    po, plse = PFA.flash_attention_lse_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v))
    np.testing.assert_allclose(
        po.numpy(), np.asarray(jo).reshape(b, h, sq, d).transpose(0, 2, 1, 3),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(plse.numpy(),
                               np.asarray(jlse).reshape(b, h, sq),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,sq,skv,h,d", SHAPES)
def test_flash_backward_matches_jax(interpret, b, sq, skv, h, d):
    """jax.grad through the JAX package's flash attention (custom VJP: K4
    with lse, then K5 and K6 via ``_flash_backward``) against the port's
    autograd Function on CPU tensors (plain D with lse, G and H)."""
    q, k, v, g = _qkv(np.random.default_rng(7 * sq + skv), b, sq, skv, h, d)
    jout, vjp = jax.vjp(JFA.flash_attention, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    pq, pk, pv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    PFA.reset_launch_counts()
    pout = PFA.flash_attention(pq, pk, pv)
    pout.backward(torch.tensor(g))
    assert dict(PFA.launches) == {"flash_attention_lse_reference": 1,
                                  "flash_attention_bwd_dkv_reference": 1,
                                  "flash_attention_bwd_dq_reference": 1}
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=RTOL)
    for name, pt, jg in zip("qkv", (pq, pk, pv), jgrads):
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_flash_backward_plain_versions_match_jax_kernels(interpret):
    """The plain G and H against ``_flash_backward`` (K5, K6) on the same
    o, lse and cotangent, with both sequences ragged against the JAX
    blocks."""
    b, sq, skv, h, d = 1, 100, 75, 2, 64
    q, k, v, g = _qkv(np.random.default_rng(3), b, sq, skv, h, d)

    def bhsd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
            b * h, x.shape[1], d)
    jo, jlse = JFA._flash_forward(bhsd(q), bhsd(k), bhsd(v))
    jdq, jdk, jdv = JFA._flash_backward(bhsd(q), bhsd(k), bhsd(v), jo, jlse,
                                        bhsd(g))

    def back(x, s):
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g))
    o = torch.tensor(back(jo, sq))
    lse = torch.tensor(np.asarray(jlse).reshape(b, h, sq))
    delta = PFA.attention_delta(o, tg)
    dk, dv = PFA.flash_attention_bwd_dkv_reference(tq, tk, tv, tg, lse, delta)
    dq = PFA.flash_attention_bwd_dq_reference(tq, tk, tv, tg, lse, delta)
    for got, want, s in ((dq, jdq, sq), (dk, jdk, skv), (dv, jdv, skv)):
        np.testing.assert_allclose(got.numpy(), back(want, s), atol=ATOL,
                                   rtol=RTOL)


def test_edm_sigma_sample_and_v_weighting():
    key = jax.random.PRNGKey(3)
    T, n = 5, 15
    want = JD.edm_sigma_sample(key, (n,), num_frames=T)
    normal = torch.tensor(np.asarray(jax.random.normal(key, (n // T,))))
    got = PD.edm_sigma_sample((n,), num_frames=T, normal=normal)
    assert rel_err(got.numpy(), want) <= REL
    assert got.shape == (n,) and bool((got[:T] == got[0]).all())
    sig = np.array([0.002, 0.3, 1.0, 7.5, 700.0], np.float32)
    assert rel_err(PD.v_weighting(torch.tensor(sig)).numpy(),
                   JD.v_weighting(jnp.asarray(sig))) <= REL
    drawn = PD.edm_sigma_sample((50,), num_frames=25,
                                generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (50,) and bool((drawn > 0).all())


@pytest.mark.parametrize("num_frames", [1, 2, 3, 25])
def test_cond_mask_choices_match_jax(num_frames):
    n = 4000
    jm = np.asarray(JL.sample_cond_mask(jax.random.PRNGKey(num_frames), n,
                                        num_frames)).reshape(n, num_frames)
    table, probs = PL.cond_choices_table(num_frames)
    rows = {tuple(r) for r in jm.tolist()}
    assert rows == {tuple(r) for r in table.tolist()}
    pm = PL.sample_cond_mask(n, num_frames, generator=torch.Generator()
                             .manual_seed(num_frames)).reshape(n, num_frames)
    for i, row in enumerate(table):
        jf = (np.abs(jm - row.numpy()).sum(1) == 0).mean()
        pf = float(((pm - row).abs().sum(1) == 0).float().mean())
        assert abs(jf - float(probs[i])) <= 0.03
        assert abs(pf - float(probs[i])) <= 0.03


def test_fourier_filter_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 16, 24, 4)).astype(
        np.float32)
    for scale, d_s in ((0.0, 0.25), (0.5, 0.1)):
        want = JL.fourier_filter(jnp.asarray(x), scale, d_s)
        got = PL.fourier_filter(torch.tensor(x), scale, d_s)
        assert rel_err(got.numpy(), want) <= REL


def _jax_draws(key, shape, T):
    """The draws JAX's ``diffusion_loss`` makes from ``key``
    (``loss.py:78``), as the port's LossDraws."""
    n = shape[0]
    k_sigma, k_mask, k_noise, k_offset = jax.random.split(key, 4)
    return PL.LossDraws(
        torch.tensor(np.asarray(jax.random.normal(k_sigma, (n // T,)))),
        torch.tensor(np.asarray(JL.sample_cond_mask(k_mask, n // T, T))),
        torch.tensor(np.asarray(jax.random.normal(k_noise, shape))),
        torch.tensor(np.asarray(jax.random.normal(k_offset,
                                                  (n, shape[-1])))))


def test_diffusion_loss_with_jax_draws():
    """Value and gradients (into the latents and a stand-in model's
    weights) of the loss with offset noise, cond frames, V-weighting, the
    temporal re-weighting and the high-frequency term."""
    T, B = 3, 2
    rng = np.random.default_rng(5)
    lat = rng.normal(size=(B * T, 8, 12, 4)).astype(np.float32)
    w = (0.3 * rng.normal(size=(4, 4))).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def jmodel(wm):
        def dfn(x, sigma, cm):
            s = sigma[:, None, None, None]
            return jnp.tanh(x @ wm) / (1 + s) + x / (1 + s * s) \
                + 0.1 * cm[:, None, None, None]
        return dfn

    def jloss(wm, latents):
        return JL.diffusion_loss(jmodel(wm), key, latents, num_frames=T,
                                 offset_noise_level=0.02,
                                 use_additional_loss=True)

    (jval, jsc), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                         has_aux=True)(jnp.asarray(w),
                                                       jnp.asarray(lat))
    pw = torch.tensor(w, requires_grad=True)
    plat = torch.tensor(lat, requires_grad=True)

    def pdfn(x, sigma, cm):
        s = sigma[:, None, None, None]
        return torch.tanh(x @ pw) / (1 + s) + x / (1 + s * s) \
            + 0.1 * cm[:, None, None, None]

    pval, psc = PL.diffusion_loss(pdfn, plat,
                                  _jax_draws(key, lat.shape, T),
                                  num_frames=T, offset_noise_level=0.02,
                                  use_additional_loss=True)
    pval.backward()
    assert rel_err(pval.detach().numpy(), jval) <= REL
    for k in ("hf_loss", "sigma_mean"):
        assert rel_err(psc[k].detach().numpy(), jsc[k]) <= REL, k
    assert rel_err(pw.grad.numpy(), jg[0]) <= REL
    assert rel_err(plat.grad.numpy(), jg[1]) <= REL


SCHEDULES = [
    ("lambda_linear", dict(warm_up_steps=[5], f_start=[1e-6], f_max=[1.0],
                           f_min=[0.1], cycle_lengths=[20])),
    ("lambda_linear", dict(warm_up_steps=[2, 3], f_start=[0.0, 0.1],
                           f_max=[1.0, 0.8], f_min=[0.5, 0.2],
                           cycle_lengths=[10, 15])),
    ("warmup_cosine", dict(warm_up_steps=[4, 0], f_start=[0.01, 0.5],
                           f_max=[1.0, 0.9], f_min=[0.0, 0.1],
                           cycle_lengths=[12, 8])),
]


@pytest.mark.parametrize("kind,kw", SCHEDULES)
def test_lr_schedules_match_jax(kind, kw):
    node = {"type": kind, **kw}
    js, ps = JS.schedule_from_config(node), PS.schedule_from_config(node)
    for step in (0, 1, 3, 4, 5, 9, 10, 11, 12, 19, 20, 24, 25, 40, 1000):
        want = float(js(step))
        assert abs(ps(step) - want) <= 1e-6 * max(abs(want), 1.0), step
    assert PS.schedule_from_config({"type": ""}) is None
    assert PS.schedule_from_config(None) is None


@pytest.fixture(scope="module")
def jax_unet_shapes():
    jeng = JEngine(JEngineConfig.tiny(num_frames=2))
    return jax.eval_shape(lambda k: jeng.init_params(k, 32, 32),
                          jax.random.PRNGKey(0))["unet"]


@pytest.mark.parametrize("flags", [{"slow_temporal_layers": True},
                                   {"slow_spatial_layers": True},
                                   {"train_peft_adapters": True}, {}])
def test_param_group_labels_match_jax(jax_unet_shapes, flags):
    """The JAX labels of each flax leaf, carried to torch names through the
    name map, equal the port's labels of its parameter names."""
    jl = JT.param_group_labels(jax_unet_shapes, **flags)
    inverse = {f: t for t, f in PCV.unet_name_map(UNetConfig.tiny()).items()}
    want = {}
    for path, lab in jax.tree_util.tree_flatten_with_path(jl)[0]:
        keys = [getattr(k, "key", str(k)) for k in path]
        if keys[0] == "params":
            keys = keys[1:]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                            keys[-1])
        want[f"{inverse['/'.join(keys[:-1])]}.{leaf}"] = lab
    with torch.device("meta"):
        from street_crafter_tpu_torch.models.vdm.unet import VideoUNet
        names = [n for n, _ in VideoUNet(UNetConfig.tiny())
                 .named_parameters()]
    got = PT.param_group_labels(names, **flags)
    assert got == want
    assert set(got.values()) >= {"base"}

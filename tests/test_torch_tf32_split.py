"""The 3xTF32 split of the f32 forms of kernels D, G and H
(``ops.flash_attention.tf32_split``), held against float64 products at the
kernels' sum lengths: 64 (the head dim: the score tiles) and 32 to 9216
(the streamed index: O, dK, dV and dQ at the UNet's levels), and through
D's online softmax over 32-key tiles. The kernels sum a_lo b_hi + a_hi
b_lo + a_hi b_hi in f32; that stays inside the f32 forms' limit (atol 2e-5
+ rtol 1e-4 of the largest |reference|, the card tests' and chip_smoke.py
phase 26's), and plain TF32 (hi alone) does not."""

import math

import numpy as np
import pytest
import torch

from street_crafter_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(1)

F32_ATOL, F32_RTOL = 2e-5, 1e-4


def limit(ref: torch.Tensor) -> float:
    return F32_ATOL + F32_RTOL * float(ref.abs().max())


def split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: three products of TF32 parts
    (each exact in f32), the two small ones first, summed in f32."""
    ah, al = FA.tf32_split(a)
    bh, bl = FA.tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def operands(m: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def test_split_parts_by_their_bits():
    """hi is x rounded to TF32 (nearest, ties away from zero), lo the rest
    truncated to TF32 (as a TF32 product reads it), and hi + lo is within
    2^-21 |x|."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 2.0 ** rng.integers(-30, 30, 4096)
         ).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    # 1 + 4099 f32 ulps rounds up to 1 + 8192 ulps, the rest -4093 ulps (12
    # significant bits) is read as -4092; 1 + 4096 ulps is a tie: away
    ulp = 2.0 ** -23
    x[4], x[5] = 1.0 + 4099 * ulp, -(1.0 + 4099 * ulp)
    x[6] = 1.0 + 4096 * ulp
    xt = torch.from_numpy(x)
    hi, lo = FA.tf32_split(xt)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    assert bool(((xt - hi).abs() <= 2.0 ** -11 * xt.abs()).all())
    err = (xt.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * xt.double().abs()).all())
    assert (float(hi[4]), float(lo[4])) == (1.0 + 8192 * ulp, -4092 * ulp)
    assert (float(hi[5]), float(lo[5])) == (-1.0 - 8192 * ulp, 4092 * ulp)
    assert (float(hi[6]), float(lo[6])) == (1.0 + 8192 * ulp, -4096 * ulp)
    assert torch.equal(FA.tf32_read(xt), (xt.view(torch.int32) & -8192).view(
        torch.float32))
    with pytest.raises(TypeError, match="float32"):
        FA.tf32_split(xt.double())


@pytest.mark.parametrize("k", [32, 64, 2304, 9216])
def test_3xtf32_products_stay_inside_the_f32_limit(k):
    """The score tiles sum over the head dim (64); dK, dV (G) and dQ (H)
    over the streamed index (32 a tile, Sq or Skv in all)."""
    a, b = operands(64, k, 64, k)
    ref = a.double() @ b.double()
    err = float((split_product(a, b).double() - ref).abs().max())
    assert err <= limit(ref), (err, limit(ref))


@pytest.mark.parametrize("k", [64, 9216])
def test_plain_tf32_misses_the_f32_limit(k):
    """hi alone (x rounded to TF32, one product), and what one TF32
    product of the raw operands gives (x truncated): each more than twice
    the limit at both sum lengths."""
    a, b = operands(64, k, 64, k)
    ref = a.double() @ b.double()
    for part in (lambda x: FA.tf32_split(x)[0], FA.tf32_read):
        one = part(a) @ part(b)
        err = float((one.double() - ref).abs().max())
        assert err > 2 * limit(ref), (err, limit(ref))


def test_3xtf32_attention_backward_stays_inside_the_f32_limit():
    """dV = P^T dO, dK = dS^T q and dQ = dS K of one (batch, head) at a
    streamed length of 2304 (level 1), every product through the split,
    against float64; p and ds in f32 as the kernels compute them."""
    rng = np.random.default_rng(7)
    s, d = 2304, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((s, d)).astype(
        np.float32)) for _ in range(4))
    scale = d ** -0.5
    s64 = (q.double() @ k.double().T) * scale
    p64 = torch.softmax(s64, dim=-1)
    o64 = p64 @ v.double()
    delta64 = (o64 * do.double()).sum(-1, keepdim=True)
    ds64 = p64 * (do.double() @ v.double().T - delta64) * scale
    want = {"dv": p64.T @ do.double(), "dk": ds64.T @ q.double(),
            "dq": ds64 @ k.double()}
    lse = torch.logsumexp(s64, dim=-1, keepdim=True).float()
    sc = split_product(q, k.T.contiguous()) * scale
    p = torch.exp(sc - lse)
    dp = split_product(do, v.T.contiguous())
    ds = p * (dp - delta64.float()) * scale
    got = {"dv": split_product(p.T.contiguous(), do),
           "dk": split_product(ds.T.contiguous(), q),
           "dq": split_product(ds, k)}
    for name, ref in want.items():
        err = float((got[name].double() - ref).abs().max())
        assert err <= limit(ref), (name, err, limit(ref))


def split_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  product=split_product) -> tuple[torch.Tensor, torch.Tensor]:
    """o and lse (natural log) of one (batch, head) as the f32 D computes
    them: key tiles of 32, S = Q K^T and O += P V by ``product``, the
    online softmax in f32 and base 2 (the scale times log2(e) folded into
    the scores), O and l rescaled between tiles."""
    sl2 = torch.tensor(q.shape[1] ** -0.5 * math.log2(math.e))
    m = torch.full((q.shape[0], 1), -math.inf)
    l = torch.zeros((q.shape[0], 1))
    acc = torch.zeros_like(q)
    for j in range(0, k.shape[0], 32):
        st = product(q, k[j:j + 32].T.contiguous())
        mn = torch.maximum(m, st.max(-1, keepdim=True).values * sl2)
        al = torch.exp2(m - mn)
        p = torch.exp2(st * sl2 - mn)
        l = l * al + p.sum(-1, keepdim=True)
        acc = acc * al + product(p, v[j:j + 32])
        m = mn
    return acc / l, ((m + torch.log2(l)) * math.log(2)).squeeze(-1)


def forward_case(s: int):
    """128 queries against s keys and values (head dim 64) and their o and
    lse in float64."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 64)).astype(
        np.float32)) for n in (128, s, s))
    s64 = (q.double() @ k.double().T) / 8.0
    return (q, k, v), {"o": torch.softmax(s64, -1) @ v.double(),
                       "lse": torch.logsumexp(s64, -1)}


@pytest.mark.parametrize("s", [576, 2304, 9216])
def test_3xtf32_attention_forward_stays_inside_the_f32_limit(s):
    """o and lse at the UNet's three streamed lengths, every product of
    the online softmax through the split, against float64."""
    (q, k, v), want = forward_case(s)
    o, lse = split_forward(q, k, v)
    for name, got in (("o", o), ("lse", lse)):
        err = float((got.double() - want[name]).abs().max())
        assert err <= limit(want[name]), (name, err, limit(want[name]))


def test_plain_tf32_attention_forward_misses_the_f32_limit():
    """The same forward at 576 keys with hi alone (x rounded to TF32, one
    product) and with the truncated read of one TF32 product: o more than
    twice the limit off in both."""
    (q, k, v), want = forward_case(576)
    ref = want["o"]
    for part in (lambda x: FA.tf32_split(x)[0], FA.tf32_read):
        o, _ = split_forward(q, k, v, lambda a, b: part(a) @ part(b))
        err = float((o.double() - ref).abs().max())
        assert err > 2 * limit(ref), (err, limit(ref))


def test_probe_model_on_the_cpu():
    """The TF32 probe's plain model: with b the identity it returns a as a
    TF32 product reads it, truncated (the card test holds the card's
    product to the same)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    FA.reset_launch_counts()
    d = FA.tf32_product_probe(a, torch.eye(8))
    assert dict(FA.launches) == {"tf32_probe_reference": 1}
    assert torch.equal(d, FA.tf32_read(a))

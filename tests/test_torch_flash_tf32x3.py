"""Why the flash-attention kernel multiplies in 3xTF32.

csrc/flash_attention.cu computes Q K^T and P V on the tensor cores through
csrc/mma_tf32x3.cuh. This file emulates that arithmetic in plain PyTorch
on the CPU and holds it against the plain version (``ref.py``):

- TF32 rounding by bit mask, to nearest with ties away from zero, as
  ``cvt.rna.tf32.f32`` rounds;
- each fp32 operand split as hi + lo, both TF32;
- per m16n8k8 step, the products lo x hi, hi x lo and hi x hi added in
  that order into an fp32 accumulator (each step's exact sum rounded to
  fp32 once), or hi x hi alone for one TF32 product; Q K^T sums its even
  and odd steps in two accumulators and adds them at the end of a key
  tile, P V carries one accumulator over all tiles;
- the kernel's online softmax over key tiles of 32, with P split the same
  way as the operands.

3xTF32 stays within fp32 rounding of the plain version, so the kernel is
held to the same tolerance as before; one TF32 product, in either of the
two products, misses that tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
from test_torch_gpu import GPU_TOL

KEY_TILE = 32     # the kernel's keys per tile (kBK)
STEP = 8          # the k depth of one m16n8k8 product

# name -> (BH, S, D, causal, window)
CASES = {
    "causal": (2, 128, 128, True, 0),
    "window_ragged_s": (2, 100, 64, True, 37),
}


def tf32(x):
    """x rounded to TF32: add half a unit of the 13 dropped mantissa bits
    to the magnitude, then clear them (sign and magnitude are separate in
    IEEE 754, so ties round away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(c, a, b, products, sets=1):
    """c + a @ b over the depth in steps of 8, as the tensor cores add one
    m16n8k8 product after another into an fp32 accumulator; with ``sets``
    accumulators, step i goes to accumulator i % sets (the first is c, the
    others start at 0), and they are added in order at the end."""
    ah, al = split(a)
    bh, bl = split(b)
    terms = ((al, bh), (ah, bl), (ah, bh)) if products == 3 else ((ah, bh),)
    acc = [c] + [torch.zeros_like(c)] * (sets - 1)
    for i, k0 in enumerate(range(0, a.shape[-1], STEP)):
        for x, y in terms:
            step = x[..., k0:k0 + STEP].double() @ y[..., k0:k0 + STEP, :] \
                .double()
            acc[i % sets] = (acc[i % sets].double() + step).float()
    return sum(acc[1:], acc[0])


def emulated_flash(q, k, v, *, causal, window, qk_products, pv_products):
    """The kernel's arithmetic on (BH, S, D) inputs, q pre-scaled."""
    BH, S, D = q.shape
    Dp = -(-D // STEP) * STEP
    pad = lambda x, rows: torch.nn.functional.pad(
        x, (0, Dp - D, 0, rows - x.shape[1]))
    q = pad(q, S)
    m = torch.full((BH, S), NEG_INF)
    l = torch.zeros((BH, S))
    o = torch.zeros((BH, S, Dp))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, KEY_TILE):
        kt = pad(k[:, k0:k0 + KEY_TILE], KEY_TILE)
        vt = pad(v[:, k0:k0 + KEY_TILE], KEY_TILE)
        s = mma(torch.zeros((BH, S, KEY_TILE)), q, kt.transpose(1, 2),
                qk_products, sets=2)
        kpos = k0 + torch.arange(KEY_TILE)[None, :]
        ok = kpos < S
        if causal:
            ok = ok & (kpos <= qpos)
        if window:
            ok = ok & (qpos - kpos < window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))      # no re-mask after the max
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        m = m_new
        o = mma(o * alpha[..., None], p, vt, pv_products)
    return o[..., :D] / torch.where(l == 0, 1.0, l)[..., None]


def _inputs(name):
    BH, S, D, causal, window = CASES[name]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((BH, S, D)) * D ** -0.5
    k = rng.standard_normal((BH, S, D))
    v = rng.standard_normal((BH, S, D))
    qkv = [torch.tensor(a, dtype=torch.float32) for a in (q, k, v)]
    return qkv, dict(causal=causal, window=window)


def _err(name, qk_products, pv_products):
    (q, k, v), kw = _inputs(name)
    got = emulated_flash(q, k, v, qk_products=qk_products,
                         pv_products=pv_products, **kw)
    return (got - attention_ref(q, k, v, **kw)).abs().max().item()


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0 + 2.0 ** -10          # the TF32 number above 1
    # a tie (to even would give 1), below and above a tie, a negative tie
    x = torch.tensor([1.0 + 2.0 ** -11, one + 2.0 ** -11 - 2.0 ** -20,
                      one + 2.0 ** -11 + 2.0 ** -20, -(1.0 + 2.0 ** -11)],
                     dtype=torch.float32)
    want = torch.tensor([one, one, one + 2.0 ** -10, -one],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    hi, lo = split(torch.tensor([1.0 / 3.0]))
    assert abs((hi + lo).item() - 1.0 / 3.0) < 2.0 ** -22


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_tf32_products_keep_fp32_accuracy(name):
    assert _err(name, 3, 3) <= 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("qk_products, pv_products", [(1, 1), (3, 1), (1, 3)])
def test_one_tf32_product_misses_the_kernel_tolerance(name, qk_products,
                                                      pv_products):
    """One TF32 product in both products, in P V alone (P lies in [0, 1]
    but still needs its low half) or in Q K^T alone misses the tolerance
    that the kernel is held to on the card."""
    assert _err(name, qk_products, pv_products) > GPU_TOL

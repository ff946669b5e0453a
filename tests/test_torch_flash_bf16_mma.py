"""The arithmetic of the flash-attention kernel's bf16 instance.

csrc/flash_attention.cu computes Q K^T and P V at bf16 with native bf16
products on the tensor cores (mma.sync m16n8k16 through csrc/mma_bf16.cuh).
This file emulates that arithmetic in plain PyTorch on the CPU:

- q, k, v as bf16 values, D zero-padded to a multiple of 16 (zero
  columns add 0);
- per m16n8k16 step, the 16 bf16 x bf16 products summed exactly (each is
  exact in fp32) and added into an fp32 accumulator, one rounding a step;
  Q K^T over D in steps of 16, P V over a key tile in steps of 16 keys;
- the kernel's 64-key tiles and its online softmax over them in fp32:
  the mask by key position (k < S, causal, window), no re-mask after the
  max, P rounded to nearest-even bf16 for P V while l sums the unrounded
  P;
- the output divided by l (l == 0 -> 1) and rounded to bf16 once.

It holds the emulation, on inputs made from a numpy seed, against the JAX
package's kernel at bf16 (``repro.kernels.flash_attention.ops``, in
interpret mode on the CPU, as tests/test_kernels.py runs it) and against
the port's plain version at bf16 (``ref.py``), both within the bf16
tolerance the card's kernel is held to (BF16_TOL). The card's kernel is
held to the plain version on the card in test_torch_gpu.py and
chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_flash_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
from test_torch_gpu import BF16_TOL

KEY_TILE = 64   # the kernel's keys per tile at D <= 128
STEP = 16       # the k depth of one m16n8k16 product

# name -> (BH, S, D, causal, window)
CASES = {
    "causal": (2, 96, 64, True, 0),
    "window_ragged_s": (2, 100, 32, True, 37),
    "non_causal": (2, 80, 64, False, 0),
    "head_dim_20": (2, 50, 20, True, 0),
}


def bf16(x):
    """x rounded to bf16 (to nearest even) and widened back to fp32."""
    return x.to(torch.bfloat16).float()


def mma(c, a, b):
    """c + a @ b over the depth in steps of 16, as the tensor cores add one
    m16n8k16 product after another into an fp32 accumulator: a and b hold
    bf16 values, so each step's sum of 16 products is exact in float64 and
    rounded to fp32 once."""
    for k0 in range(0, a.shape[-1], STEP):
        step = a[..., k0:k0 + STEP].double() @ b[..., k0:k0 + STEP, :] \
            .double()
        c = (c.double() + step).float()
    return c


def emulated_flash(q, k, v, *, causal, window):
    """The bf16 kernel's arithmetic on (BH, S, D) bf16 inputs, q
    pre-scaled; returns bf16."""
    BH, S, D = q.shape
    Dp = -(-D // STEP) * STEP
    pad = lambda x, rows: torch.nn.functional.pad(
        x.float(), (0, Dp - D, 0, rows - x.shape[1]))
    q = pad(q, S)
    m = torch.full((BH, S), NEG_INF)
    l = torch.zeros((BH, S))
    o = torch.zeros((BH, S, Dp))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, KEY_TILE):
        kt = pad(k[:, k0:k0 + KEY_TILE], KEY_TILE)
        vt = pad(v[:, k0:k0 + KEY_TILE], KEY_TILE)
        s = mma(torch.zeros((BH, S, KEY_TILE)), q, kt.transpose(1, 2))
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
        l = alpha * l + p.sum(-1)                 # the unrounded P
        m = m_new
        o = mma(o * alpha[..., None], bf16(p), vt)
    out = o[..., :D] / torch.where(l == 0, 1.0, l)[..., None]
    return out.to(torch.bfloat16)


def _inputs(name):
    """bf16 q (pre-scaled), k, v from a numpy seed, and the mask's
    arguments."""
    BH, S, D, causal, window = CASES[name]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((BH, S, D)) * D ** -0.5
    k = rng.standard_normal((BH, S, D))
    v = rng.standard_normal((BH, S, D))
    qkv = [torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)
           for a in (q, k, v)]
    return qkv, dict(causal=causal, window=window)


def _assert_bf16_close(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_matches_the_jax_kernel_at_bf16(name):
    """The emulation against the JAX package's Pallas kernel at bf16, run
    in interpret mode through its public wrapper (model layout, one head
    a batch row)."""
    (q, k, v), kw = _inputs(name)
    got = emulated_flash(q, k, v, **kw)
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)[:, :,
                                                                    None]
    want = jax_flash_ops.flash_attention(as_jax(q), as_jax(k), as_jax(v),
                                         **kw)[:, :, 0]
    assert want.dtype == jnp.bfloat16
    _assert_bf16_close(got, torch.tensor(np.asarray(want, np.float32)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_matches_the_plain_version_at_bf16(name):
    """The emulation against the port's plain version at bf16: the
    yardstick the card's kernel is held to."""
    (q, k, v), kw = _inputs(name)
    got = emulated_flash(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_products_round_only_in_the_fp32_sums(name):
    """Q K^T of bf16 values through m16n8k16 steps stays within fp32
    rounding of the exact product: a bf16 x bf16 product is exact in fp32,
    so only the accumulator rounds (a product that rounded its operands,
    as one TF32 product of fp32 values does, would not)."""
    (q, k, _), _ = _inputs(name)
    got = mma(torch.zeros(q.shape[:2] + (k.shape[1],)), q.float(),
              k.float().transpose(1, 2))
    exact = q.double() @ k.double().transpose(1, 2)
    scale = (q.double().abs() @ k.double().abs().transpose(1, 2)).max()
    assert ((got.double() - exact).abs().max() / scale).item() < 2.0 ** -21

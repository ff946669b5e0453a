"""Why the SSD chunk kernel multiplies in 3xTF32, and why its outputs do
not depend on how a launch is packed.

csrc/ssd_scan.cu computes the scores C B^T, y = G x and the state
(B o w)^T x on the tensor cores through csrc/mma_tf32x3.cuh. This file
emulates that arithmetic in plain PyTorch on the CPU:

- each fp32 operand split as hi + lo, both TF32 (``split`` of
  test_torch_flash_tf32x3.py, rounding as ``cvt.rna.tf32.f32`` does);
- per m16n8k8 step, the products lo x hi, hi x lo and hi x hi added in
  that order into an fp32 accumulator (each step's 8 products summed
  exactly, in float64 in a fixed order, and rounded to fp32 once), or
  hi x hi alone for one TF32 product;
- the kernel's order, fixed by absolute position: a score sums its 8-wide
  step k over n into accumulator k % 4, and the four are added in order
  at the end; y and the state carry one accumulator over the 8-key steps
  j;
- the gates in fp32 as the kernel forms them: G = where(j <= i,
  s * exp(dA_i - dA_j) * dt_j, 0) and B_j * w_j with w_j = exp(dA_last -
  dA_j) * dt_j.

The emulation stays within the kernel's tolerance (SSD_TOL, relative to
max(1, max |plain|)) of the plain version and of the JAX package's
reference; one TF32 product misses it. (The bf16 instance is a design of
its own, emulated in test_torch_ssd_bf16_mma.py.) A bc gives the same
bits alone and inside a packed launch, and a chunk padded with dt = 0 to
any of the pool's l buckets the same bits in its real rows and its state;
the same identities hold for the kernel on the card (test_torch_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from test_torch_flash_tf32x3 import split
from test_torch_gpu import (SSD_BUCKET_LENS, SSD_MODES, SSD_TOL,
                            ssd_bucket_case, ssd_buckets, ssd_case, ssd_err,
                            to_torch)

STEP = 8   # the k depth of one m16n8k8 product

# the modes held against the JAX reference: every mode but the two widest
# (l100_mamba, l256_mamba: their emulation alone takes seconds)
SMALL_MODES = sorted(m for m in SSD_MODES
                     if m not in ("l100_mamba", "l256_mamba"))


def mma(a, b, products, sets=1):
    """a @ b over the depth in steps of 8, as the tensor cores add one
    m16n8k8 product after another into an fp32 accumulator; with ``sets``
    accumulators, step i goes to accumulator i % sets, and they are added
    in order at the end."""
    ah, al = split(a)
    bh, bl = split(b)
    # 3xTF32, or hi x hi alone
    terms = {3: ((al, bh), (ah, bl), (ah, bh)), 1: ((ah, bh),)}[products]
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) \
        + (a.shape[-2], b.shape[-1])
    acc = [torch.zeros(shape) for _ in range(sets)]
    for i, k0 in enumerate(range(0, a.shape[-1], STEP)):
        for x, y in terms:
            s = acc[i % sets].double()
            for k in range(k0, min(k0 + STEP, a.shape[-1])):
                s = s + x[..., :, k, None].double() * y[..., k, None, :] \
                    .double()
            acc[i % sets] = s.float()
    return sum(acc[1:], acc[0])


def _exp(x):
    """fp32 exp, computed in float64 and rounded once (the same bits
    whatever the tensor's size)."""
    return torch.exp(x.double()).float()


def emulated_ssd(x, dt, da, B, C, products=3):
    """The kernel's arithmetic in its layout: x (BC, H, l, P); dt, da
    (BC, H, l, 1); B, C (BC, l, N), fp32 tensors. ``products`` TF32
    products per fp32 product. Returns (y, state (BC, H, N, P))."""
    dt, da = dt[..., 0], da[..., 0]
    l = x.shape[2]
    s = mma(C, B.transpose(1, 2), products, sets=4)          # (BC, i, j)
    below = torch.ones((l, l), dtype=torch.bool).tril()
    rel = torch.where(below, da[..., :, None] - da[..., None, :], 0.0)
    G = torch.where(below, s[:, None] * _exp(rel) * dt[..., None, :], 0.0)
    y = mma(G, x, products)
    w = _exp(da[..., -1:] - da) * dt                         # (BC, H, l)
    A = B.transpose(1, 2)[:, None] * w[:, :, None, :]        # (BC, H, N, l)
    return y, mma(A, x, products)


def emulated_chunk(xs, dts, das, Bs, Cs, products=3):
    """The model-layout entry: xs (b, nc, l, H, P); dts, das (b, nc, l,
    H); Bs, Cs (b, nc, l, N). Returns (y (b, nc, l, H, P), states (b, nc,
    H, P, N)), as the kernel reads and writes them through strides."""
    b, nc, l, H, P = xs.shape
    flat = lambda t: t.flatten(0, 1)
    y, st = emulated_ssd(flat(xs).movedim(1, 2),
                         flat(dts).movedim(1, 2)[..., None],
                         flat(das).movedim(1, 2)[..., None], flat(Bs),
                         flat(Cs), products)
    return (y.movedim(1, 2).reshape(b, nc, l, H, P),
            st.transpose(2, 3).reshape(b, nc, H, P, -1))


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", SMALL_MODES)
def test_three_tf32_products_stay_within_the_kernel_tolerance(mode):
    args = ssd_case(mode)
    y, st = emulated_ssd(*to_torch(args))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    want = ssd_chunk_ref(*to_torch(args))
    with jax.default_matmul_precision("highest"):
        jwant = jax.jit(jax_ssd_ref)(*[jnp.asarray(a) for a in args])
    for got, plain, ref in zip((y, st), want, jwant):
        assert ssd_err(got, plain) <= SSD_TOL, (mode, ssd_err(got, plain))
        ref = torch.from_numpy(np.array(ref))
        assert ssd_err(got, ref) <= SSD_TOL, (mode, ssd_err(got, ref))
    if SSD_MODES[mode][-1] == "pad":
        assert not st[-1].any(), "a dt = 0 row must add exactly 0"


@pytest.mark.parametrize("mode", ["l16_pad_dt0_mamba", "l100_mamba"])
def test_one_tf32_product_misses_the_kernel_tolerance(mode):
    """With hi x hi alone (about 2^-11 relative a product) the scores' sums
    over N = 128 and y's over the chunk miss SSD_TOL at mamba2-130m's
    widths."""
    args = to_torch(ssd_case(mode))
    y, st = emulated_ssd(*args, products=1)
    want_y, want_st = ssd_chunk_ref(*args)
    assert max(ssd_err(y, want_y), ssd_err(st, want_st)) > SSD_TOL


@pytest.mark.parametrize("l", [2, 16, 17])
def test_a_bc_alone_is_bitwise_packed(l):
    """Nothing in the emulated order depends on BC: each of 8 packed
    chunks gives the bits it gives alone."""
    args = to_torch(ssd_bucket_case(l, l, seed=l, H=2, P=16, N=32))
    packed = emulated_chunk(*args)
    for k in range(args[0].shape[0]):
        alone = emulated_chunk(*(t[k:k + 1] for t in args))
        for got, want in zip(alone, packed):
            assert torch.equal(got[0], want[k]), (l, k)


@pytest.mark.parametrize("n", SSD_BUCKET_LENS)
def test_l_buckets_are_bitwise_equal(n):
    """A chunk of n real positions padded with dt = 0 to each of the
    pool's l buckets: the padding's G and w are 0 by select or by dt = 0,
    every step sits at the same absolute positions, so y's n rows and the
    state come out with the same bits."""
    outs = []
    for l in ssd_buckets(n):
        y, st = emulated_chunk(*to_torch(ssd_bucket_case(n, l, H=2, P=16,
                                                         N=32)))
        outs.append((l, y[:, :, :n], st))
    for l, y, st in outs[1:]:
        assert torch.equal(y, outs[0][1]), (n, l)
        assert torch.equal(st, outs[0][2]), (n, l)

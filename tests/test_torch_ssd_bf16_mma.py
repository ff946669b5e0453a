"""The arithmetic of the SSD chunk kernel's bf16 design.

csrc/ssd_scan.cu's bf16 entry (ssd_chunk_scan_bf16) is a design of its
own (namespace bf16_ssd): the fp32 design's roles and summation order, on
bf16 tiles of x, B and C, with every product a native bf16 mma.sync
m16n8k16 (csrc/mma_bf16.cuh). This file emulates that arithmetic in plain
PyTorch on the CPU:

- x, B and C as bf16 values, dt and dA fp32; N zero-padded to a multiple
  of 16 (zero columns add 0);
- per m16n8k16 step, the 16 bf16 x bf16 products summed exactly (each is
  exact, and the step's sum is taken in float64 in a fixed order) and
  added into an fp32 accumulator, one rounding a step;
- the scores C B^T over N in k16 steps, step k into accumulator k % 4,
  the four added in order at the end;
- the gates in fp32 as the kernel forms them: G = where(j <= i, s *
  exp(dA_i - dA_j) * dt_j, 0), and B_j * w_j with w_j = exp(dA_last -
  dA_j) * dt_j;
- G and B o w split into bf16 parts, hi = bf16(v), mid = bf16(v - hi)
  (and lo = bf16(v - hi - mid) for three), each rounded to nearest even;
- y = G x and the state (B o w)^T x over 16-key steps in increasing
  order, each step adding the parts' products smallest first (mid x,
  then hi x).

The emulation with two parts stays within the kernel's tolerance (SSD_TOL,
relative to max(1, max |plain|)) of the port's plain version at bf16, and
of the JAX package's Pallas kernel run in interpret mode at bf16; one part
misses it at mamba2-130m's widths. A bc gives the same bits alone and
inside a packed launch, and a chunk padded with dt = 0 to any of the
pool's l buckets the same bits in its real rows and its state; the card's
kernel is held to the same identities in test_torch_gpu.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_chunk_scan as jax_ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from test_torch_gpu import (SSD_BUCKET_LENS, SSD_MODES, SSD_TOL,
                            ssd_bucket_case, ssd_buckets, ssd_case, ssd_err,
                            to_torch)

STEP = 16    # the k depth of one m16n8k16 product
PARTS = 2    # the design's bf16 parts of G and of B o w

# the modes of the fp32 design's emulation (test_torch_ssd_tf32x3.py):
# every mode but the two widest, whose emulation alone takes seconds
SMALL_MODES = sorted(m for m in SSD_MODES
                     if m not in ("l100_mamba", "l256_mamba"))
# the modes also held against the JAX package's Pallas kernel in
# interpret mode (each a few seconds)
PALLAS_BF16_MODES = ("sweep_l64", "l16_pad_dt0_mamba", "l17_tile_edge")


def bf16(x):
    """x rounded to bf16 (to nearest even) and widened back to fp32."""
    return x.to(torch.bfloat16).float()


def parts(v, n):
    """v (fp32) as n bf16 parts, largest first: hi = bf16(v), then each
    part the bf16 of what the ones before leave, in fp32."""
    out = []
    for _ in range(n):
        out.append(bf16(v))
        v = v - out[-1]
    return out


def mma(a_parts, b, sets=1):
    """sum(a_parts) @ b over the depth in steps of 16, as the tensor cores
    add one m16n8k16 product after another into an fp32 accumulator: at
    each step each part of a (bf16 values, smallest first) times b (bf16
    values), its 16 products summed in float64 in order (exact) and
    added to the accumulator with one rounding; with ``sets``
    accumulators, step i goes to accumulator i % sets, and they are added
    in order at the end. The depth is zero-padded to a multiple of 16."""
    depth = b.shape[-2]
    pad = -depth % STEP
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).double()
    a_parts = [torch.nn.functional.pad(a, (0, pad)).double()
               for a in a_parts]
    shape = torch.broadcast_shapes(a_parts[0].shape[:-2], b.shape[:-2]) \
        + (a_parts[0].shape[-2], b.shape[-1])
    acc = [torch.zeros(shape) for _ in range(sets)]
    for i, k0 in enumerate(range(0, depth + pad, STEP)):
        for a in a_parts:
            s = acc[i % sets].double()
            for k in range(k0, k0 + STEP):
                s = s + a[..., :, k, None] * b[..., k, None, :]
            acc[i % sets] = s.float()
    return sum(acc[1:], acc[0])


def _exp(x):
    """fp32 exp, computed in float64 and rounded once (the same bits
    whatever the tensor's size)."""
    return torch.exp(x.double()).float()


def emulated_ssd(x, dt, da, B, C, n_parts=PARTS):
    """The bf16 design's arithmetic in the kernel's layout: x (BC, H, l,
    P); dt, da (BC, H, l, 1); B, C (BC, l, N), fp32 tensors, x, B and C
    holding bf16 values. Returns (y, state (BC, H, N, P))."""
    dt, da = dt[..., 0], da[..., 0]
    l = x.shape[2]
    s = mma([C], B.transpose(1, 2), sets=4)                  # (BC, i, j)
    below = torch.ones((l, l), dtype=torch.bool).tril()
    rel = torch.where(below, da[..., :, None] - da[..., None, :], 0.0)
    G = torch.where(below, s[:, None] * _exp(rel) * dt[..., None, :], 0.0)
    y = mma(parts(G, n_parts)[::-1], x)
    w = _exp(da[..., -1:] - da) * dt                         # (BC, H, l)
    A = B.transpose(1, 2)[:, None] * w[:, :, None, :]        # (BC, H, N, l)
    return y, mma(parts(A, n_parts)[::-1], x)


def emulated_chunk(xs, dts, das, Bs, Cs):
    """The model-layout entry: xs (b, nc, l, H, P); dts, das (b, nc, l,
    H); Bs, Cs (b, nc, l, N). Returns (y (b, nc, l, H, P), states (b, nc,
    H, P, N)), as the kernel reads and writes them through strides."""
    b, nc, l, H, P = xs.shape
    flat = lambda t: t.flatten(0, 1)
    y, st = emulated_ssd(flat(xs).movedim(1, 2),
                         flat(dts).movedim(1, 2)[..., None],
                         flat(das).movedim(1, 2)[..., None], flat(Bs),
                         flat(Cs))
    return (y.movedim(1, 2).reshape(b, nc, l, H, P),
            st.transpose(2, 3).reshape(b, nc, H, P, -1))


def bf16_inputs(args):
    """numpy inputs (x, dt, dA, B, C) with x, B and C rounded to bf16:
    the JAX arrays, and the same values as fp32 torch tensors."""
    jargs = [jnp.asarray(a, jnp.bfloat16) if i in (0, 3, 4)
             else jnp.asarray(a) for i, a in enumerate(args)]
    return jargs, to_torch([np.asarray(a, np.float32) for a in jargs])


def bf16_typed(ts):
    """x, B and C as torch bf16 tensors (dt and dA fp32), as the model
    hands them to the kernel."""
    return [t.to(torch.bfloat16) if i in (0, 3, 4) else t
            for i, t in enumerate(ts)]


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", SMALL_MODES)
def test_two_bf16_parts_stay_within_the_kernel_tolerance(mode):
    """Two bf16 parts of G and of B o w, each against bf16 x on the
    tensor cores, and the scores from bf16 C and B, stay within SSD_TOL of
    the plain version on the same bf16 inputs, and for PALLAS_BF16_MODES
    of the reference's Pallas kernel in interpret mode at bf16. A dt = 0
    row's state is exactly 0."""
    jargs, bf = bf16_inputs(ssd_case(mode))
    y, st = emulated_ssd(*bf)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    want = ssd_chunk_ref(*bf16_typed(bf))
    for got, plain in zip((y, st), want):
        assert ssd_err(got, plain) <= SSD_TOL, (mode, ssd_err(got, plain))
    if mode in PALLAS_BF16_MODES:
        jwant = jax_ssd_kernel(*jargs, interpret=True)
        for got, ref in zip((y, st), jwant):
            ref = torch.from_numpy(np.array(ref))
            assert ssd_err(got, ref) <= SSD_TOL, (mode, ssd_err(got, ref))
    if SSD_MODES[mode][-1] == "pad":
        assert not st[-1].any(), "a dt = 0 row must add exactly 0"


@pytest.mark.parametrize("mode", ["l16_pad_dt0_mamba", "l100_mamba"])
def test_one_bf16_part_misses_the_kernel_tolerance(mode):
    """G and B o w rounded to bf16 alone (about 2^-9 relative a product)
    miss SSD_TOL at mamba2-130m's widths, while two parts keep it."""
    _, bf = bf16_inputs(ssd_case(mode))
    want_y, want_st = ssd_chunk_ref(*bf16_typed(bf))
    errs = {}
    for n in (1, 2):
        y, st = emulated_ssd(*bf, n_parts=n)
        errs[n] = max(ssd_err(y, want_y), ssd_err(st, want_st))
    assert errs[1] > SSD_TOL >= errs[2], errs


@pytest.mark.parametrize("l", [2, 16, 17])
def test_a_bc_alone_is_bitwise_packed(l):
    """Nothing in the emulated order depends on BC: each of 8 packed
    chunks gives the bits it gives alone."""
    _, args = bf16_inputs(ssd_bucket_case(l, l, seed=l, H=2, P=16, N=32))
    packed = emulated_chunk(*args)
    for k in range(args[0].shape[0]):
        alone = emulated_chunk(*(t[k:k + 1] for t in args))
        for got, want in zip(alone, packed):
            assert torch.equal(got[0], want[k]), (l, k)


@pytest.mark.parametrize("n", SSD_BUCKET_LENS)
def test_l_buckets_are_bitwise_equal(n):
    """A chunk of n real positions padded with dt = 0 to each of the
    pool's l buckets: the padding's G and w are 0 by select or by dt = 0,
    and every k16 step sits at the same absolute positions, so y's n rows
    and the state come out with the same bits."""
    outs = []
    for l in ssd_buckets(n):
        _, args = bf16_inputs(ssd_bucket_case(n, l, H=2, P=16, N=32))
        y, st = emulated_chunk(*args)
        outs.append((l, y[:, :, :n], st))
    for l, y, st in outs[1:]:
        assert torch.equal(y, outs[0][1]), (n, l)
        assert torch.equal(st, outs[0][2]), (n, l)

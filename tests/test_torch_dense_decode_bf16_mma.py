"""The arithmetic of the dense decode kernel's bf16 design.

csrc/decode_attention.cu's bf16 entry (decode_attention_bf16) is a design
of its own (``namespace bf16_dense``): the fp32 design's split walk
(128-key splits aligned from key 0, a block per (row b, kv head, block of
up to 16 rows, split), the splits merged in split order by the last
block), with the G query rows of a kv head as one m16 tile of native bf16
products on the tensor cores (mma.sync m16n8k16 through csrc/mma_bf16.cuh)
and each warp's 32-key slice of K and V rows copied into shared memory,
an invalid key's row zero-filled. This file emulates that arithmetic in
plain PyTorch on the CPU:

- q, k and v as bf16 values, D zero-padded to a multiple of 16 and the
  query rows to 16 (zero columns and rows add 0);
- per m16n8k16 step, the 16 bf16 x bf16 products summed exactly and
  added into an fp32 accumulator, one rounding a step: Q K^T over D in
  steps of 16, P V over a slice's 32 keys in steps of 16
  (test_torch_flash_bf16_mma.py's ``mma``);
- each warp's slice in one softmax step over its four 8-key score tiles:
  an invalid key (or one past S) has a zero K and V row, is out of the
  max and has p = 0; P rounded to nearest-even bf16 for P V while l sums
  the unrounded P; a slice with no valid key is the empty state
  (m, l) = (-1e30, 0) and is never read;
- the warps merged in warp order, each non-empty state weighted by
  exp(m - M) for M the largest m; the splits merged in split order in
  chunks of 8 or 16, a running (M, l, acc) rescaled once a chunk;
- one split: the output divided by l (l == 0 -> 1) in the block; else the
  partials merged by the last block; a row with no valid key gets the mean
  of V over its S keys; the output rounded to bf16 once.

It holds the emulation, on inputs made from a numpy seed, within the
reference's own bf16 tolerance (KERNEL_TOL below) of the port's plain
version at bf16 and of the JAX package's Pallas kernel at bf16 in
interpret mode, over every dense decode launch mode plus G = 6, 12 and 18
(``DECODE_DENSE_GQA_MODES``); and, in the emulation, bit for bit: a row
alone equals the batch, 256 invalid keys appended change nothing, and NaN
in the K and V rows of invalid keys changes nothing. The card's kernel is
held to the same in test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention_gqa as jax_decode_kernel
from repro_torch.kernels.decode_attention import ops
from test_torch_flash_bf16_mma import bf16, mma
from test_torch_gpu import (BF16_TOL, DECODE_DENSE_GQA_MODES,
                            DECODE_DENSE_MODES, decode_dense_case, to_torch)

NEG_INF = -1e30
# test_torch_bf16.py's KERNEL_TOL: the reference's own bf16 tolerance for
# its kernels against their oracles (allclose, rtol = atol)
KERNEL_TOL = BF16_TOL
SPLIT_KEYS = 128   # keys of one split (kSplitKeys)
WARPS = 4          # warps of a block (DENSE_BF16_WARPS)
SLICE = SPLIT_KEYS // WARPS   # keys of a warp's slice (kSK)
ROWS = 16          # query rows of a block: one m16 tile (kRows)
STEP = 16          # the k depth of one m16n8k16 product
MODES = {**DECODE_DENSE_MODES, **DECODE_DENSE_GQA_MODES}


def empty_state(n, D):
    return (torch.full((n, ROWS), NEG_INF), torch.zeros((n, ROWS)),
            torch.zeros((n, ROWS, D)))


def merge(states):
    """States (m, l, acc) merged in order, as the kernel merges its warps:
    M the largest m; each state with l > 0 weighted by exp(m - M) and added
    in order; a state with l = 0 is never used."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L, A = torch.zeros_like(M), torch.zeros_like(states[0][2])
    for m, l, a in states:
        x = torch.exp(m - M)
        use = l > 0
        L = torch.where(use, L + x * l, L)
        A = torch.where(use[..., None], A + x[..., None] * a, A)
    return M, L, A


def merge_splits(states, chunk):
    """The splits' partials merged in split order, as the last block merges
    them: a running (M, L, A) over chunks of ``chunk`` splits, rescaled once
    a chunk to the chunk's largest m; a split with l = 0 adds nothing."""
    M, L, A = empty_state(*states[0][2].shape[::2])
    for j0 in range(0, len(states), chunk):
        part = states[j0:j0 + chunk]
        m_new = M
        for m, _, _ in part:
            m_new = torch.maximum(m_new, m)
        scale = torch.exp(M - m_new)
        L, A = L * scale, A * scale[..., None]
        for m, l, a in part:
            w = torch.exp(m - m_new)
            use = l > 0
            L = torch.where(use, L + w * l, L)
            A = torch.where(use[..., None], A + w[..., None] * a, A)
        M = m_new
    return M, L, A


def merge_chunk(D, rows):
    """Splits a chunk of the last block's merge: 8 where it loads 4 columns
    a thread (D a multiple of 4 and rows x D at least 4 x 128), else 16."""
    return 8 if D % 4 == 0 and rows * D >= 4 * 32 * WARPS else 16


def slice_state(q, k, v, ok):
    """One warp's slice: q (n, 16, Dp), k and v (n, SLICE, Dp) with the
    rows of invalid keys already zero, ok (n, SLICE). The empty state
    where no key of the slice is valid."""
    sc = mma(torch.zeros(q.shape[:2] + (SLICE,)), q, k.transpose(1, 2))
    okr = ok[:, None, :]
    m = torch.where(okr, sc, NEG_INF).amax(-1)
    p = torch.where(okr, torch.exp(sc - m[..., None]), 0.0)
    o = mma(torch.zeros(q.shape), bf16(p), v)
    some = ok.any(-1)[:, None]
    m0, l0, o0 = empty_state(*q.shape[::2])
    return (torch.where(some, m, m0), torch.where(some, p.sum(-1), l0),
            torch.where(some[..., None], o, o0))


def mean_of_v(v):
    """The no-valid-key rows' output: V summed over its S keys in key
    order, times 1 / S. v (n, S, D) fp32 of bf16 values."""
    total = torch.zeros((v.shape[0], v.shape[2]))
    for s in range(v.shape[1]):
        total = total + v[:, s]
    return total * (1.0 / v.shape[1])


def emulated_decode(q, k, v, valid, return_parts=False):
    """The bf16 design's arithmetic on the production layout: q (B, H, D)
    bf16 pre-scaled, k and v (B, S, K, D) bf16, valid (B, S). Returns
    (B, H, D) bf16, and with ``return_parts`` each row block's split
    states (None for a split with no valid key)."""
    B, S, K, D = k.shape
    G = q.shape[1] // K
    Dp = -(-D // STEP) * STEP
    NS = -(-S // SPLIT_KEYS)
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, Dp - D))
    kh = pad(k).movedim(2, 1).reshape(B * K, S, Dp)   # (n, S, Dp)
    vh = pad(v).movedim(2, 1).reshape(B * K, S, Dp)
    ok_all = (valid > 0).repeat_interleave(K, 0)       # (n, S)
    qh = pad(q).reshape(B * K, G, Dp)
    out = torch.zeros((B * K, G, D))
    parts = {}
    for row0 in range(0, G, ROWS):
        rows = min(ROWS, G - row0)
        qr = torch.zeros((B * K, ROWS, Dp))
        qr[:, :rows] = qh[:, row0:row0 + rows]
        splits = []
        for s in range(NS):
            warps = []
            for w in range(WARPS):
                keys = s * SPLIT_KEYS + w * SLICE + torch.arange(SLICE)
                inside = keys < S
                at = keys.clamp(max=S - 1)
                ok = ok_all[:, at] & inside
                kk = torch.where(ok[..., None], kh[:, at], 0.0)
                vv = torch.where(ok[..., None], vh[:, at], 0.0)
                warps.append(slice_state(qr, kk, vv, ok))
            state = merge(warps)
            # a split with no valid key records (-1e30, 0) and nothing else
            some = (state[1] > 0).any(-1)
            splits.append((torch.where(some[:, None], state[0], NEG_INF),
                           torch.where(some[:, None], state[1], 0.0),
                           state[2], some))
        parts[row0] = splits
        if NS == 1:
            _, L, A, _ = splits[0]
        else:
            _, L, A = merge_splits([sp[:3] for sp in splits],
                                   merge_chunk(D, rows))
        inv = 1.0 / torch.where(L == 0, 1.0, L)
        res = A * inv[..., None]
        mean = mean_of_v(vh)[:, None, :]
        res = torch.where((L > 0)[..., None], res, mean)
        out[:, row0:row0 + rows] = res[:, :rows, :D]
    out = out.reshape(B, K * G, D).to(torch.bfloat16)
    return (out, parts) if return_parts else out


def _bf16_case(mode):
    q, k, v, valid = to_torch(decode_dense_case(mode, modes=MODES))
    return q.to(torch.bfloat16), k.to(torch.bfloat16), \
        v.to(torch.bfloat16), valid


def _assert_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_emulated_design_matches_the_plain_version_at_bf16(mode):
    """The emulation against the port's plain version at bf16: the
    yardstick the card's kernel is held to."""
    q, k, v, valid = _bf16_case(mode)
    _assert_close(emulated_decode(q, k, v, valid),
                  ops.decode_attention_kv(q, k, v, valid))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_emulated_design_matches_the_jax_kernel_at_bf16(mode):
    """The emulation against the JAX package's Pallas kernel at bf16, in
    interpret mode on the CPU, in the TPU kernel's layout (BK, G, D)."""
    q, k, v, valid = _bf16_case(mode)
    got = emulated_decode(q, k, v, valid)
    B, S, K, D = k.shape
    G = q.shape[1] // K
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    want = jax_decode_kernel(
        as_jax(q.reshape(B * K, G, D)),
        as_jax(k.movedim(2, 1).reshape(B * K, S, D)),
        as_jax(v.movedim(2, 1).reshape(B * K, S, D)),
        jnp.asarray(np.repeat(valid.numpy(), K, axis=0)), interpret=True)
    assert want.dtype == jnp.bfloat16
    _assert_close(got, torch.tensor(np.asarray(want, np.float32))
                  .to(torch.bfloat16).reshape(B, K * G, D))


@pytest.mark.parametrize("mode", ["window_long", "windowed_sink", "gqa",
                                  "irregular_s", "gqa_6", "gqa_12",
                                  "rows_past_16"])
def test_bits_do_not_depend_on_trailing_keys_or_the_batch(mode):
    """256 invalid positions with random K and V appended to the cache (two
    more splits, a longer last split; irregular_s goes from one split to
    three) give the same bits; so does each row emulated alone."""
    q, k, v, valid = _bf16_case(mode)
    base = emulated_decode(q, k, v, valid)
    B, S, K, D = k.shape
    g = torch.Generator().manual_seed(1)
    tail = lambda t: torch.cat([t, torch.randn(
        (B, 256, K, D), generator=g).to(torch.bfloat16)], 1)
    wide = emulated_decode(q, tail(k), tail(v), torch.cat(
        [valid, torch.zeros((B, 256), dtype=torch.int8)], 1))
    assert torch.equal(wide, base), mode
    for b in range(B):
        alone = emulated_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                valid[b:b + 1])
        assert torch.equal(alone[0], base[b]), (mode, b)


@pytest.mark.parametrize("mode", ["windowed_sink", "window_long", "gqa",
                                  "gqa_12"])
def test_nan_in_invalid_rows_changes_nothing(mode):
    """NaN in every K and V row of an invalid key leaves every bit: such a
    row is zero-filled in shared memory, never read."""
    q, k, v, valid = _bf16_case(mode)
    base = emulated_decode(q, k, v, valid)
    bad = (valid == 0)[..., None, None].expand_as(k)
    k, v = (torch.where(bad, float("nan"), t.float()).to(torch.bfloat16)
            for t in (k, v))
    got = emulated_decode(q, k, v, valid)
    assert torch.isfinite(got.float()).all() and torch.equal(got, base)


def test_an_empty_state_adds_exactly_nothing():
    """An empty slice (l = 0) is never used: merged before, after or
    between others it leaves the warps' merge bit for bit; empty splits
    after the last leave the splits' merge bit for bit (whole chunks of
    them too); and a merge of one state gives that state's (l, acc)
    exactly (so one split written by its block equals the same split
    merged by the last block)."""
    q, k, v, valid = _bf16_case("window_long")
    _, parts = emulated_decode(q, k, v, valid, return_parts=True)
    splits = [sp[:3] for sp in parts[0]]
    some = [bool(sp[3].all()) for sp in parts[0]]
    assert some[0] is False and any(some)
    full = [sp for sp, used in zip(splits, some) if used]
    empty = splits[0]
    want = merge(full)
    for order in (full + [empty], [empty] + full,
                  full[:1] + [empty, empty] + full[1:]):
        assert all(torch.equal(x, y) for x, y in zip(merge(order), want))
    one = full[0]
    assert all(torch.equal(x, y) for x, y in zip(merge([one])[1:], one[1:]))
    for chunk in (8, 16):
        want = merge_splits(full, chunk)
        got = merge_splits(full + [empty] * 40, chunk)
        assert all(torch.equal(x, y) for x, y in zip(got[1:], want[1:]))
        assert all(torch.equal(x, y)
                   for x, y in zip(merge_splits([one], chunk)[1:], one[1:]))


def test_the_modes_reach_what_they_are_there_for():
    """gqa_6 and gqa_12: one 16-row block of 6 and 12 rows, read once;
    rows_past_16: a second row block of 2 rows; window_long: splits with
    no valid key on both sides of splits with work; windowed_sink: the
    first four splits empty; gqa: slices whose valid keys are scattered."""
    for mode, blocks in (("gqa_6", [0]), ("gqa_12", [0]),
                         ("rows_past_16", [0, 16])):
        _, parts = emulated_decode(*_bf16_case(mode), return_parts=True)
        assert sorted(parts) == blocks, mode
    _, parts = emulated_decode(*_bf16_case("window_long"), return_parts=True)
    some = [bool(sp[3].any()) for sp in parts[0]]
    assert len(some) == 5 and not some[0] and not some[-1] and sum(some) >= 3
    _, parts = emulated_decode(*_bf16_case("windowed_sink"),
                               return_parts=True)
    assert not any(bool(sp[3].any()) for sp in parts[0][:4])
    valid = decode_dense_case("gqa")[3]
    assert 0 < valid.mean() < 1

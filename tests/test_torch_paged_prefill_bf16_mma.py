"""The arithmetic of the paged prefill kernel's bf16 design.

csrc/paged_prefill_attention.cu's bf16 entry (paged_prefill_attention_bf16)
is a design of its own: the same split page walk as the fp32 instance
(128-key splits aligned from page 0, a block per (slot, kv head, row
block, split), the splits merged in split order), with native bf16
products on the tensor cores (mma.sync m16n8k16 through csrc/mma_bf16.cuh)
on bf16 K and V tiles. This file emulates that arithmetic in plain
PyTorch on the CPU:

- q and the pages as bf16 values, D zero-padded to a multiple of 16
  (zero columns add 0);
- per m16n8k16 step, the 16 bf16 x bf16 products summed exactly (each is
  exact in fp32) and added into an fp32 accumulator, one rounding a step:
  Q K^T over D in steps of 16, P V over a warp's key slice in steps of 16
  keys;
- the key tiles and warp slices: a 64-key tile at D <= 128 (32 keys at
  D = 256 from 32 rows up, never under 16 keys a warp), whose keys the
  block's KW = 4 / (rows / 16) warps of each 16 rows share in slices of
  whole k16 steps (16 keys each at 16 rows, 32 at 32 rows, the whole tile
  at 64);
- each warp's online softmax in fp32 over its slices, with the mask by
  global position and the re-mask after the max (a masked key adds
  exactly 0 even while m is still -1e30); P rounded to nearest-even bf16
  for P V while l sums the unrounded P;
- the warps of each 16 rows merged in warp order, the splits in split
  order (test_torch_paged_prefill_split.py's ``merge`` and ``combine``);
- the output divided by l (l == 0 -> 1) and rounded to bf16 once.

It holds the emulation, on inputs made from a numpy seed, against the JAX
package's kernel at bf16 (in interpret mode, as tests/test_chunked_prefill.py
runs it) and against the port's plain version at bf16, both within
BF16_TOL, and bit for bit against itself under two page-walk bounds. The
card's kernel is held to the plain version, and to itself under the same
bounds and packings, in test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_prefill_attention.kernel import \
    paged_prefill_attention_gqa as jax_prefill_kernel
from repro_torch.kernels.paged_prefill_attention import ops
from test_torch_flash_bf16_mma import bf16, mma
from test_torch_gpu import BF16_TOL, PREFILL_MODES, prefill_case, to_torch
from test_torch_paged_prefill_split import (NEG_INF, block_rows, combine,
                                            empty_state, merge, split_pages,
                                            visible_pages)

KEY_TILE = 64       # the bf16 design's keys a tile at D <= 128
KEY_TILE_256 = 32   # and at D = 256
WARPS = 4

MODES = ["split_walk", "page8_split_edge", "window_splits", "rows_64",
         "rows_past_16", "head_dim_256"]


def dim_tile(D):
    """head_dim rounded up to the kernel instance that takes it."""
    return 32 if D <= 32 else 64 if D <= 64 else 128 if D <= 128 else 256


def key_tile(D, rows):
    """Keys of a tile: at least 16 for each warp sharing 16 rows."""
    want = KEY_TILE_256 if dim_tile(D) > 128 else KEY_TILE
    return max(want, 16 * (WARPS // (rows // 16)))


def slice_keys(D, rows):
    """Keys of a warp's slice of a tile."""
    return key_tile(D, rows) // (WARPS // (rows // 16))


def softmax_step(m, l, o, sc, ok, v):
    """One warp's online-softmax step over a slice: scores ``sc`` (rows,
    keys) masked where ``ok`` is false, re-masked after the max, P rounded
    to bf16 for P V while l sums the unrounded P; alpha is exactly 1
    where m does not move."""
    sc = torch.where(ok, sc, NEG_INF)
    m_new = torch.maximum(m, sc.amax(-1))
    alpha = torch.where(m_new == m, 1.0, torch.exp(m - m_new))
    p = torch.where(ok, torch.exp(sc - m_new[:, None]), 0.0)
    return m_new, alpha * l + p.sum(-1), mma(o * alpha[:, None], bf16(p), v)


def split_partial(q, kp, vp, pt_row, qpos, s, sp, p_begin, p_end, total,
                  window, h, D):
    """One block's split: each warp's key slice of each tile through its
    online softmax, the slices merged in warp order."""
    R, Dp = q.shape
    ps = kp.shape[1]
    tk, sk = key_tile(D, R), slice_keys(D, R)
    pa, pb = max(s * sp, p_begin), min((s + 1) * sp, p_end)
    ksplit, k_lo, k_hi = s * sp * ps, pa * ps, pb * ps
    j_begin, j_end = (k_lo - ksplit) // tk, -(-(k_hi - ksplit) // tk)
    pad = lambda x: torch.nn.functional.pad(x, (0, Dp - x.shape[1]))
    warps = []
    for kg in range(tk // sk):
        m, l, o = empty_state(R, Dp)
        for j in range(j_begin, j_end):
            kpos = ksplit + j * tk + sk * kg + torch.arange(sk)
            inside = (kpos >= k_lo) & (kpos < k_hi)
            page = pt_row[torch.clamp(kpos // ps, 0, len(pt_row) - 1)]
            k = pad(torch.where(inside[:, None], kp[page, kpos % ps, h], 0.0))
            v = pad(torch.where(inside[:, None], vp[page, kpos % ps, h], 0.0))
            sc = mma(torch.zeros((R, sk)), q, k.T)
            ok = inside[None] & (kpos[None] <= qpos[:, None]) \
                & (kpos[None] < total)
            if window:
                ok &= qpos[:, None] - kpos[None] < window
            m, l, o = softmax_step(m, l, o, sc, ok, v)
        warps.append((m, l, o))
    state = warps[0]
    for part in warps[1:]:
        state = merge(state, part)
    return state


def emulated_prefill(q, kp, vp, pt, start, total, pages_bound=None,
                     pages_start=0, window=0):
    """The bf16 design's arithmetic on (B, K, C, G, D) bf16 q (pre-scaled)
    and bf16 pages; returns bf16."""
    B, K, C, G, D = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    end = MP if pages_bound is None else pages_bound
    CG, Dp = C * G, -(-D // 16) * 16
    R = block_rows(CG)
    sp = split_pages(ps)
    qf = torch.nn.functional.pad(q.float().reshape(B, K, CG, D),
                                 (0, Dp - D))
    kp, vp = kp.float(), vp.float()
    out = torch.zeros((B, K, CG, D))
    for b in range(B):
        for h in range(K):
            for row0 in range(0, CG, R):
                rows = min(R, CG - row0)
                qrows = torch.zeros((R, Dp))
                qrows[:rows] = qf[b, h, row0:row0 + rows]
                qpos = int(start[b]) + torch.clamp(
                    row0 + torch.arange(R), max=CG - 1) // G
                p_begin, p_end = visible_pages(
                    int(start[b]), int(total[b]), row0, rows, G, ps,
                    pages_start, end, window)
                splits = range(p_begin // sp, -(-p_end // sp)) \
                    if p_end > p_begin else range(0)
                res = combine([split_partial(
                    qrows, kp, vp, pt[b].long(), qpos, s, sp, p_begin,
                    p_end, int(total[b]), window, h, D) for s in splits])
                if res is not None:
                    out[b, h, row0:row0 + rows] = res[:rows, :D]
    return out.reshape(B, K, C, G, D).to(torch.bfloat16)


def _bf16_case(mode):
    """A launch mode's inputs with q and the pages rounded to bf16."""
    args, kw = prefill_case(mode)
    q, kp, vp, pt, start, total = to_torch(args)
    return [q.to(torch.bfloat16), kp.to(torch.bfloat16),
            vp.to(torch.bfloat16), pt, start, total], kw


def _assert_bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", MODES)
def test_emulated_design_matches_the_jax_kernel_at_bf16(mode):
    """The emulation against the JAX package's Pallas kernel at bf16, in
    interpret mode on the CPU; an idle slot gives exactly 0."""
    args, kw = _bf16_case(mode)
    got = emulated_prefill(*args, **kw)
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16) \
        if t.is_floating_point() else jnp.asarray(t.numpy())
    want = jax_prefill_kernel(*[as_jax(t) for t in args], interpret=True,
                              **kw)
    assert want.dtype == jnp.bfloat16
    _assert_bf16_close(got, torch.tensor(np.asarray(want, np.float32))
                       .to(torch.bfloat16))
    if not kw["window"]:
        assert not got[-1].float().any(), "an idle slot must give exactly 0"


@pytest.mark.parametrize("mode", MODES)
def test_emulated_design_matches_the_plain_version_at_bf16(mode):
    """The emulation against the port's plain version at bf16: the
    yardstick the card's kernel is held to."""
    args, kw = _bf16_case(mode)
    _assert_bf16_close(emulated_prefill(*args, **kw),
                       ops.paged_prefill_attention_ref(*args, **kw))


@pytest.mark.parametrize("mode", MODES)
def test_emulated_design_does_not_depend_on_pages_bound(mode):
    """The pages the slots need and the table's full width give the same
    bits: what a block sums depends on its slot's start and total."""
    args, kw = _bf16_case(mode)
    ps = args[1].shape[1]
    needed = max(kw["pages_start"] + 1, -(-int(args[5].max()) // ps))
    live = emulated_prefill(*args, **dict(kw, pages_bound=needed))
    static = emulated_prefill(*args, **dict(kw, pages_bound=None))
    assert torch.equal(live, static), mode


@pytest.mark.parametrize("D,rows,tile,slice_", [
    (128, 16, 64, 16), (128, 32, 64, 32), (128, 64, 64, 64),
    (32, 16, 64, 16), (18, 32, 64, 32), (256, 16, 64, 16),
    (256, 32, 32, 16), (256, 64, 32, 32)])
def test_tiles_are_whole_k16_steps(D, rows, tile, slice_):
    """Every warp's slice of a tile is a whole number of 16-key P V steps
    (two m16n8 score tiles a step), the warps of 16 rows cover the tile,
    and a 128-key split is whole tiles; at the main shape (16 rows, D =
    128) one split is two 64-key tiles, which a 2-stage ring holds."""
    assert (key_tile(D, rows), slice_keys(D, rows)) == (tile, slice_)
    assert slice_ % 16 == 0
    assert slice_ * (WARPS // (rows // 16)) == tile
    assert 128 % tile == 0


def test_the_modes_reach_every_slice_width():
    """MODES cover each slice width of the design and both tile widths:
    16-key slices at 16 rows, 32 at 32, 64 at 64, and D = 256."""
    seen = set()
    for mode in MODES:
        _, _, C, G, D, *_ = PREFILL_MODES[mode]
        rows = block_rows(C * G)
        seen.add((slice_keys(D, rows), dim_tile(D) > 128))
    assert {(16, False), (32, False), (64, False)} <= seen
    assert any(wide for _, wide in seen)


def test_a_slice_with_no_visible_key_leaves_the_bits():
    """A step whose keys are all masked leaves (m, l, acc) bit for bit,
    from the empty state (m = -1e30: the re-mask keeps exp(-1e30 + 1e30)
    = 1 from counting the masked keys) and from a state that has seen
    keys (alpha exactly 1). So a block that walks such a slice, or skips
    it, gives the same bits: the live and static walks, and a window walk
    from either first page, rest on this. A step with visible keys
    rounds P, not l."""
    rng = np.random.default_rng(3)
    R, SK, Dp = 16, 16, 32
    sc = torch.tensor(rng.standard_normal((R, SK)), dtype=torch.float32)
    v = bf16(torch.tensor(rng.standard_normal((SK, Dp)),
                          dtype=torch.float32))
    none = torch.zeros((R, SK), dtype=torch.bool)
    empty = empty_state(R, Dp)
    after = softmax_step(*empty, sc, none, v)
    assert all(torch.equal(a, b) for a, b in zip(after, empty))
    seen = softmax_step(*empty, sc, ~none, v)
    again = softmax_step(*seen, sc - 5.0, none, v)
    assert all(torch.equal(a, b) for a, b in zip(again, seen))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    assert torch.equal(seen[1], p.sum(-1)) and not torch.equal(bf16(p), p)

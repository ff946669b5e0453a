"""The paged prefill kernel's split page walk, emulated on the CPU.

csrc/paged_prefill_attention.cu splits each slot's page walk into splits
of 128 keys (whole pages, aligned from page 0), runs each split in its own
block, and the last block of a row block to finish merges the splits'
partials in split order. Inside a block each
warp takes 16 rows and a slice of every 32-key tile (8 keys at 16 rows, 16
at 32 rows, the whole tile at 64), keeps its own online softmax with the
re-mask, multiplies in 3xTF32, and the warps are merged in warp order.
This file emulates that arithmetic in plain PyTorch fp32 (the TF32 steps
as tests/test_torch_flash_tf32x3.py emulates them for flash attention)
and holds it against the plain version and the JAX package's ref.py:

- the split walk and its combine are right, within 1e-5;
- a split that holds no visible key contributes exactly nothing;
- the result does not depend on ``pages_bound``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_prefill_attention.ref import \
    paged_prefill_attention_ref as jax_prefill_ref
from repro_torch.kernels.paged_prefill_attention import ops
from test_torch_flash_tf32x3 import mma
from test_torch_gpu import PREFILL_MODES, prefill_case, to_torch

NEG_INF = -1e30
EMU_TOL = 1e-5
SPLIT_KEYS = 128   # keys of one split (the kernel's kSplitKeys)


def split_pages(ps):
    """Pages of one split: SPLIT_KEYS keys, at least one page."""
    return max(1, SPLIT_KEYS // ps)


def block_rows(CG):
    """Query rows of one block: 16, 32 or 64 (16 x row_warps)."""
    return 16 if CG <= 16 else 32 if CG <= 32 else 64


def key_tile(D, rows):
    return 16 if D > 128 and rows == 64 else 32


def visible_pages(qstart, total, row0, rows, G, ps, pages_start, pages_end,
                  window):
    """The pages [p_begin, p_end) a row block can see (the kernel's
    ``visible_pages``)."""
    q_lo = qstart + row0 // G
    q_hi = qstart + (row0 + rows - 1) // G
    key_end = min(total, q_hi + 1)
    p_end = min(pages_end, -(-key_end // ps) if key_end > 0 else 0)
    p_begin = pages_start
    if window > 0 and q_lo - window + 1 > 0:
        p_begin = max(p_begin, (q_lo - window + 1) // ps)
    return p_begin, p_end


def merge(state, part):
    """(m, l, acc) absorbs ``part``, as the kernel's merge_weights."""
    m, l, a = state
    mi, li, ai = part
    m_new = torch.maximum(m, mi)
    x, y = torch.exp(m - m_new), torch.exp(mi - m_new)
    return m_new, x * l + y * li, x[:, None] * a + y[:, None] * ai


def empty_state(rows, Dp):
    return (torch.full((rows,), NEG_INF), torch.zeros(rows),
            torch.zeros((rows, Dp)))


def combine(parts):
    """The partials of one row block merged in split order and normalised,
    as the kernel's merge_splits_if_last (one partial: normalised alone);
    no partial gives None."""
    if not parts:
        return None
    if len(parts) == 1:
        _, l, a = parts[0]
        return a * (1.0 / torch.where(l == 0, 1.0, l))[:, None]
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    a = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + w * l
        a = a + w[:, None] * acc
    return a * (1.0 / torch.where(L == 0, 1.0, L))[:, None]


def split_partial(q, kp, vp, pt_row, qpos, s, sp, p_begin, p_end, total,
                  window, h):
    """One block's split: each warp's key slice of each tile through its
    online softmax, the slices merged in warp order."""
    R, Dp = q.shape
    ps = kp.shape[1]
    tk = key_tile(Dp, R)
    kw_n = 4 // (R // 16)              # warps per 16 rows
    nt = tk // 8 // kw_n               # m16n8 score tiles per warp
    rows_per_kg = 8 * nt
    pa, pb = max(s * sp, p_begin), min((s + 1) * sp, p_end)
    ksplit, k_lo, k_hi = s * sp * ps, pa * ps, pb * ps
    j_begin, j_end = (k_lo - ksplit) // tk, -(-(k_hi - ksplit) // tk)
    nacc = 4 if nt == 1 else 2
    warps = []
    for kg in range(kw_n):
        m, l, o = empty_state(R, Dp)
        for j in range(j_begin, j_end):
            kpos = ksplit + j * tk + rows_per_kg * kg + torch.arange(
                rows_per_kg)
            inside = (kpos >= k_lo) & (kpos < k_hi)
            page = pt_row[torch.clamp(kpos // ps, 0, len(pt_row) - 1)]
            k = torch.where(inside[:, None], kp[page, kpos % ps, h], 0.0)
            v = torch.where(inside[:, None], vp[page, kpos % ps, h], 0.0)
            k = torch.nn.functional.pad(k, (0, Dp - k.shape[1]))
            v = torch.nn.functional.pad(v, (0, Dp - v.shape[1]))
            sc = mma(torch.zeros((R, rows_per_kg)), q, k.T, 3, sets=nacc)
            ok = inside[None] & (kpos[None] <= qpos[:, None]) \
                & (kpos[None] < total)
            if window:
                ok &= qpos[:, None] - kpos[None] < window
            sc = torch.where(ok, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.where(ok, torch.exp(sc - m_new[:, None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            m = m_new
            o = mma(o * alpha[:, None], p, v, 3)
        warps.append((m, l, o))
    state = warps[0]
    for part in warps[1:]:
        state = merge(state, part)
    return state


def emulated_prefill(q, kp, vp, pt, start, total, pages_bound=None,
                     pages_start=0, window=0, return_parts=False):
    """The kernel's arithmetic on (B, K, C, G, D) q, pre-scaled."""
    B, K, C, G, D = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    end = MP if pages_bound is None else pages_bound
    CG, Dp = C * G, -(-D // 16) * 16
    R = block_rows(CG)
    sp = split_pages(ps)
    qf = torch.nn.functional.pad(q.reshape(B, K, CG, D), (0, Dp - D))
    out = torch.zeros((B, K, CG, D))
    parts = {}
    for b in range(B):
        for h in range(K):
            for row0 in range(0, CG, R):
                rows = min(R, CG - row0)
                qrows = torch.zeros((R, Dp))
                qrows[:rows] = qf[b, h, row0:row0 + rows]
                qpos = int(start[b]) + torch.clamp(
                    row0 + torch.arange(R), max=CG - 1) // G
                pb_, pe_ = visible_pages(int(start[b]), int(total[b]), row0,
                                         rows, G, ps, pages_start, end,
                                         window)
                splits = range(pb_ // sp, -(-pe_ // sp)) if pe_ > pb_ \
                    else range(0)
                got = [split_partial(qrows, kp, vp, pt[b].long(), qpos, s,
                                     sp, pb_, pe_, int(total[b]), window, h)
                       for s in splits]
                parts[b, h, row0] = got
                res = combine(got)
                if res is not None:
                    out[b, h, row0:row0 + rows] = res[:rows, :D]
    out = out.reshape(B, K, C, G, D)
    return (out, parts) if return_parts else out


MODES = ["split_walk", "page8_split_edge", "window_splits", "rows_past_16",
         "rows_64"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", MODES)
def test_split_walk_matches_plain_version_and_jax_ref(mode):
    args, kw = prefill_case(mode)
    got = emulated_prefill(*to_torch(args), **kw)
    plain = ops.paged_prefill_attention_ref(*to_torch(args), **kw)
    ref = torch.tensor(np.asarray(jax_prefill_ref(
        *[jnp.asarray(a) for a in args], **kw)))
    assert (got - plain).abs().max().item() <= EMU_TOL, mode
    assert (got - ref).abs().max().item() <= EMU_TOL, mode
    if not kw["window"]:
        assert not got[-1].any(), "an idle slot must give exactly 0"


def test_the_walk_spans_several_splits_and_row_blocks():
    """The modes reach what they are there for: several splits per row
    block, a chunk across the first split boundary, and row blocks with
    padding."""
    _, parts = emulated_prefill(*to_torch(prefill_case("split_walk")[0]),
                                return_parts=True)
    assert max(len(p) for p in parts.values()) >= 3
    args, kw = prefill_case("page8_split_edge")
    assert split_pages(args[1].shape[1]) * args[1].shape[1] == SPLIT_KEYS
    start, total = args[4], args[5]
    assert ((start <= 128) & (total > 128)).any()
    for mode, rows in (("rows_past_16", 32), ("rows_64", 64)):
        _, _, C, G, *_ = PREFILL_MODES[mode]
        assert block_rows(C * G) == rows and C * G % rows


def test_an_empty_split_contributes_exactly_nothing():
    """A partial with no visible key (m = -1e30, l = 0, acc = 0), merged at
    any place in the order, leaves the combined output bit for bit."""
    _, parts = emulated_prefill(*to_torch(prefill_case("split_walk")[0]),
                                return_parts=True)
    _, got = max(parts.items(), key=lambda kv: len(kv[1]))
    want = combine(got)
    empty = empty_state(*got[0][2].shape)
    for at in range(len(got) + 1):
        assert torch.equal(combine(got[:at] + [empty] + got[at:]), want), at
    assert torch.equal(combine([empty, empty]), torch.zeros_like(want))


@pytest.mark.parametrize("mode", ["split_walk", "window_splits"])
def test_split_walk_does_not_depend_on_pages_bound(mode):
    args, kw = prefill_case(mode)
    ps = args[1].shape[1]
    needed = max(kw["pages_start"] + 1, -(-int(args[5].max()) // ps))
    live = emulated_prefill(*to_torch(args), **dict(kw, pages_bound=needed))
    static = emulated_prefill(*to_torch(args), **dict(kw, pages_bound=None))
    assert torch.equal(live, static), mode

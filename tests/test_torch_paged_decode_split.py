"""The paged decode kernel's split page walk, emulated on the CPU.

csrc/paged_decode_attention.cu splits each slot's page walk into splits
of 128 keys (whole pages, aligned from page 0), runs each split in its own
block, and the last block of a row block to finish merges the splits'
partials in split order. A block takes up to 8 rows of a kv head's group
(4 at head_dim > 128); each of its 4 warps takes a contiguous slice of the
split's keys and runs its own online softmax over stages of a few keys,
with the re-mask, and the warps are merged in warp order. This file
emulates that arithmetic in plain PyTorch fp32 and holds it against the
plain version and the JAX package's ref.py:

- the split walk and its merges are right, within 1e-5, on every decode
  launch mode;
- a split or a warp slice that holds no visible key contributes exactly
  nothing;
- the result does not depend on ``pages_bound``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_decode_attention.ref import \
    paged_decode_attention_ref as jax_decode_ref
from repro_torch.kernels.paged_decode_attention import ops
from test_torch_gpu import DECODE_LENS, DECODE_MODES, decode_case, to_torch

NEG_INF = -1e30
EMU_TOL = 1e-5
SPLIT_KEYS = 128   # keys of one split (the kernel's kSplitKeys)
WARPS = 4          # warps of a block (kWarps)
KEYS = 4           # keys of a stage at D = 128 (DECODE_KEYS)


def split_pages(ps):
    """Pages of one split: SPLIT_KEYS keys, at least one page, at most
    32."""
    return max(1, min(32, SPLIT_KEYS // ps))


def lane_cols(D):
    return 1 if D <= 32 else 2 if D <= 64 else 4 if D <= 128 else 8


def block_rows(G, D):
    """Query rows of one block: G rounded up to 1, 2, 4 or 8; at most 4
    at head_dim > 128."""
    r = 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8
    return min(r, 4) if D > 128 else r


def stage_keys(D, R):
    """Keys a warp has in flight in a stage (the kernel's stage_keys)."""
    return max(1, min(KEYS * 4 // lane_cols(D), 16 // R))


def visible_keys(length, ps, pages_start, pages_end, window):
    """The keys [k_lo, k_hi) every row of a slot sees."""
    k_lo = pages_start * ps
    if window:
        k_lo = max(k_lo, length - window)
    return k_lo, min(length, pages_end * ps)


def empty_state(rows, D):
    return (torch.full((rows,), NEG_INF), torch.zeros(rows),
            torch.zeros((rows, D)))


def absorb(state, part):
    """(m, l, acc) absorbs ``part``, as the kernel's ``absorb``."""
    m, l, a = state
    mi, li, ai = part
    m_new = torch.maximum(m, mi)
    x, y = torch.exp(m - m_new), torch.exp(mi - m_new)
    return m_new, x * l + y * li, x[:, None] * a + y[:, None] * ai


def normalised(state):
    _, l, a = state
    return a * (1.0 / torch.where(l == 0, 1.0, l))[:, None]


def combine(parts):
    """A row block's split partials merged in split order and normalised
    (one partial: normalised alone); no partial gives None."""
    if not parts:
        return None
    state = parts[0]
    for part in parts[1:]:
        state = absorb(state, part)
    return normalised(state)


def warp_partial(q, k, v, a, e, U):
    """One warp's keys [a, e) of a head's keys in position order, through
    each row's online softmax a stage of U keys at a time."""
    m, l, acc = empty_state(*q.shape)
    for k0 in range(a, e, U):
        kk, vv = k[k0:min(k0 + U, e)], v[k0:min(k0 + U, e)]
        sc = q @ kk.T
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[:, None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = alpha[:, None] * acc + p @ vv
        m = m_new
    return m, l, acc


def split_partial(q, k, v, s, sk, k_lo, k_hi, U):
    """One block's split: each warp's slice, merged in warp order."""
    ks, kpw = s * sk, -(-sk // WARPS)
    state = empty_state(*q.shape)
    for w in range(WARPS):
        a = max(ks + w * kpw, k_lo)
        e = min(ks + min((w + 1) * kpw, sk), k_hi)
        state = absorb(state, warp_partial(q, k, v, a, e, U))
    return state


def emulated_decode(q, kp, vp, pt, lens, pages_bound=None, pages_start=0,
                    window=0, return_parts=False):
    """The kernel's arithmetic on (B, K, G, D) q, pre-scaled."""
    B, K, G, D = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    end = MP if pages_bound is None else pages_bound
    sk = split_pages(ps) * ps
    R = block_rows(G, D)
    U = stage_keys(D, R)
    out = torch.zeros((B, K, G, D))
    parts = {}
    for b in range(B):
        # the slot's keys in position order: (MP * ps, K, D)
        keys = kp[pt[b].long()].reshape(MP * ps, K, D)
        vals = vp[pt[b].long()].reshape(MP * ps, K, D)
        k_lo, k_hi = visible_keys(int(lens[b]), ps, pages_start, end, window)
        splits = range(k_lo // sk, -(-k_hi // sk)) if k_hi > k_lo \
            else range(0)
        for h in range(K):
            for row0 in range(0, G, R):
                rows = min(R, G - row0)
                qrows = torch.zeros((R, D))
                qrows[:rows] = q[b, h, row0:row0 + rows]
                got = [split_partial(qrows, keys[:, h], vals[:, h], s, sk,
                                     k_lo, k_hi, U) for s in splits]
                parts[b, h, row0] = got
                res = combine(got)
                if res is not None:
                    out[b, h, row0:row0 + rows] = res[:rows]
    return (out, parts) if return_parts else out


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", sorted(DECODE_MODES))
def test_split_walk_matches_plain_version_and_jax_ref(mode):
    args, kw = decode_case(mode)
    got = emulated_decode(*to_torch(args), **kw)
    plain = ops.paged_decode_attention_ref(*to_torch(args), **kw)
    ref = torch.tensor(np.asarray(jax_decode_ref(
        *[jnp.asarray(a) for a in args], **kw)))
    assert (got - plain).abs().max().item() <= EMU_TOL, mode
    assert (got - ref).abs().max().item() <= EMU_TOL, mode
    if not kw["window"]:
        assert not got[-1].any(), "an idle slot must give exactly 0"


def test_the_modes_reach_what_they_are_there_for():
    """Several splits per row block with single-split slots beside them;
    lengths on both sides of the split edges at ps = 8; windows that start
    and end in different splits; a second row block with padding rows;
    8-byte loads (head_dim 64), 4-byte loads (head_dim % 4 != 0) at 2 and
    4 columns a lane, and head_dim 256 at G = 2."""
    _, parts = emulated_decode(*to_torch(decode_case("split_walk_idle")[0]),
                               return_parts=True)
    counts = {len(p) for p in parts.values()}
    assert max(counts) >= 3 and 1 in counts and 0 in counts
    args, _ = decode_case("page8_split_edges")
    assert split_pages(args[1].shape[1]) * args[1].shape[1] == SPLIT_KEYS
    assert {127, 128, 129, 255, 256, 257} <= set(DECODE_LENS[
        "page8_split_edges"])
    args, kw = decode_case("window_across_splits")
    lo = np.maximum(args[4] - kw["window"], kw["pages_start"] * 8)
    assert (lo // SPLIT_KEYS < (args[4] - 1) // SPLIT_KEYS).all()
    G, D = DECODE_MODES["rows_past_8"][2:4]
    assert block_rows(G, D) == 8 and G % 8 and lane_cols(D) == 2
    for mode, cols in (("head_dim_98", 4), ("window_across_splits", 2)):
        D = DECODE_MODES[mode][3]
        assert D % 4 and lane_cols(D) == cols, mode
    G, D = DECODE_MODES["head_dim_256_g2"][2:4]
    assert (G, D) == (2, 256) and block_rows(G, D) == 2


def test_an_empty_split_contributes_exactly_nothing():
    """A partial with no visible key (m = -1e30, l = 0, acc = 0), merged at
    any place in the order, leaves the merged output bit for bit; so does
    an empty warp slice inside a split."""
    args, _ = decode_case("split_walk_idle")
    _, parts = emulated_decode(*to_torch(args), return_parts=True)
    _, got = max(parts.items(), key=lambda kv: len(kv[1]))
    want = combine(got)
    empty = empty_state(*got[0][2].shape)
    for at in range(len(got) + 1):
        assert torch.equal(combine(got[:at] + [empty] + got[at:]), want), at
    assert torch.equal(combine([empty, empty]), torch.zeros_like(want))
    q = torch.randn((1, 32))
    k, v = torch.randn((64, 32)), torch.randn((64, 32))
    one = warp_partial(q, k, v, 3, 40, 8)
    for state in (absorb(empty_state(1, 32), one), absorb(one, warp_partial(
            q, k, v, 50, 50, 8))):
        assert all(torch.equal(x, y) for x, y in zip(state, one))


@pytest.mark.parametrize("mode", ["split_walk_idle", "page8_split_edges",
                                  "window_across_splits"])
def test_split_walk_does_not_depend_on_pages_bound(mode):
    args, kw = decode_case(mode)
    ps = args[1].shape[1]
    needed = max(kw["pages_start"] + 1, -(-int(args[4].max()) // ps))
    live = emulated_decode(*to_torch(args), **dict(kw, pages_bound=needed))
    static = emulated_decode(*to_torch(args), **dict(kw, pages_bound=None))
    assert torch.equal(live, static), mode

"""The dense decode kernel's split key walk, emulated on the CPU.

csrc/decode_attention.cu splits each row's keys into splits of 128 keys
(aligned from key 0), runs each split in its own block, and the last block
of a row block to finish merges the splits' partials in split order. A
block takes up to 8 rows of a kv head's group (4 at head_dim > 128); each
of its 4 warps takes a 32-key slice of the split, makes the slice's mask
from its validity bytes by a ballot, and walks from its first valid key to
its last in stages of a few keys, skipping stages with no valid key and
reading nothing for an invalid key, with the re-mask; the warps are merged
in warp order. A split with no valid key only records an empty partial,
whose accumulator the merge never reads. A row with no valid key at all
gets the mean of V over its S keys. This file emulates that arithmetic in
plain PyTorch fp32 and holds it against the plain version and the JAX
package's ref.py:

- the split walk and its merges are right, within 1e-5, on every dense
  decode launch mode;
- an empty split or warp slice contributes exactly nothing, and no K or V
  row of an invalid key is read;
- the result is bit-identical with invalid keys appended after the last
  valid split (S grows), and for a row run alone or in a batch.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention import ops
from test_torch_gpu import DECODE_DENSE_MODES, decode_dense_case, to_torch

NEG_INF = -1e30
EMU_TOL = 1e-5
SPLIT_KEYS = 128   # keys of one split (the kernel's kSplitKeys)
WARPS = 4          # warps of a block (kWarps)
SLICE = SPLIT_KEYS // WARPS   # keys of a warp's slice (kSliceKeys)
KEYS = 8           # keys of a stage at D = 128 (DENSE_KEYS)


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


def merge_chunk(D):
    """Partials the merging block loads before it uses any (SC)."""
    return 4 if lane_cols(D) > 4 else 8


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


def warp_partial(q, k, v, ok, sl, se, U):
    """One warp's slice [sl, se) of a head's keys: from its first valid key
    to its last, a stage of U keys at a time; an invalid key loads zeros
    and is out of the max and the sums; a stage with no valid key is
    skipped."""
    m, l, acc = empty_state(*q.shape)
    idx = [s for s in range(sl, se) if ok[s]]
    if not idx:
        return m, l, acc
    a, e = idx[0], idx[-1] + 1
    for k0 in range(a, e, U):
        keys = torch.arange(k0, k0 + U)
        bits = torch.tensor([s < e and bool(ok[s]) for s in keys.tolist()])
        if not bits.any():
            continue
        at = keys.clamp(max=k.shape[0] - 1)
        kk = torch.where(bits[:, None], k[at], 0.0)
        vv = torch.where(bits[:, None], v[at], 0.0)
        sc = q @ kk.T
        mx = torch.where(bits, sc, NEG_INF).amax(-1)
        m_new = torch.maximum(m, mx)
        p = torch.where(bits, torch.exp(sc - m_new[:, None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = alpha[:, None] * acc + p @ vv
        m = m_new
    return m, l, acc


def mean_of_v(v, rows):
    """The no-valid-key row's output: each warp sums keys w, w + WARPS, ...;
    the warps' sums are added in warp order and scaled by 1 / S."""
    total = torch.zeros(v.shape[1])
    for w in range(WARPS):
        total = total + v[w::WARPS].sum(0)
    return (total * (1.0 / v.shape[0]))[None].expand(rows, -1)


def split_partial(q, k, v, ok, s, U):
    """One block's split: each warp's slice, merged in warp order. None
    where no key of the split is valid (an empty partial)."""
    S = k.shape[0]
    state, any_valid = empty_state(*q.shape), False
    for w in range(WARPS):
        sl = s * SPLIT_KEYS + w * SLICE
        se = min(sl + SLICE, (s + 1) * SPLIT_KEYS, S)
        any_valid |= bool(ok[sl:se].any()) if sl < se else False
        state = absorb(state, warp_partial(q, k, v, ok, sl, se, U))
    return state if any_valid else None


def merge_splits(parts, D):
    """The merging block: the partials in split order, SC at a time, a
    running (M, L, A) rescaled once a chunk; an empty partial (None) is
    (-1e30, 0) and its accumulator is not read. Returns (L, A)."""
    rows = next((p[0].shape[0] for p in parts if p is not None), 1)
    M, L, A = empty_state(rows, D)
    SC = merge_chunk(D)
    for i0 in range(0, len(parts), SC):
        chunk = [p if p is not None else empty_state(rows, D)
                 for p in parts[i0:i0 + SC]]
        m_new = M
        for mi, _, _ in chunk:
            m_new = torch.maximum(m_new, mi)
        scale = torch.exp(M - m_new)
        L, A = L * scale, A * scale[:, None]
        for mi, li, x in chunk:
            w = torch.exp(mi - m_new)
            L = L + w * li
            A = A + w[:, None] * x
        M = m_new
    return L, A


def row_block(q, k, v, ok, U, return_parts=False):
    """One (row b, kv head, row block): q (R, D) padded rows, k and v
    (S, D) of the head, ok (S,) bool."""
    S, D = k.shape
    NS = -(-S // SPLIT_KEYS)
    parts = [split_partial(q, k, v, ok, s, U) for s in range(NS)]
    if NS == 1:
        res = mean_of_v(v, q.shape[0]) if parts[0] is None else \
            parts[0][2] * (1.0 / parts[0][1])[:, None]
    else:
        L, A = merge_splits(parts, D)
        res = mean_of_v(v, q.shape[0]) if not (L > 0).all() else \
            A * (1.0 / L)[:, None]
    return (res, parts) if return_parts else res


def emulated_decode(q, k, v, valid, return_parts=False):
    """The kernel's arithmetic on the production layout: q (B, H, D)
    pre-scaled, k and v (B, S, K, D), valid (B, S). Returns (B, H, D)."""
    B, S, K, D = k.shape
    G = q.shape[1] // K
    R = block_rows(G, D)
    U = stage_keys(D, R)
    out = torch.zeros((B, K * G, D))
    parts = {}
    for b in range(B):
        ok = valid[b] > 0
        for h in range(K):
            for row0 in range(0, G, R):
                rows = min(R, G - row0)
                qrows = torch.zeros((R, D))
                qrows[:rows] = q[b, h * G + row0:h * G + row0 + rows]
                res, got = row_block(qrows, k[b, :, h], v[b, :, h], ok, U,
                                     return_parts=True)
                parts[b, h, row0] = got
                out[b, h * G + row0:h * G + row0 + rows] = res[:rows]
    return (out, parts) if return_parts else out


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", sorted(DECODE_DENSE_MODES))
def test_split_walk_matches_plain_version_and_jax_ref(mode):
    q, k, v, valid = decode_dense_case(mode)
    got = emulated_decode(*to_torch((q, k, v, valid)))
    plain = ops.decode_attention_kv(*to_torch((q, k, v, valid)))
    B, S, K, D = k.shape
    G = q.shape[1] // K
    ref = np.asarray(jax_decode_ref(
        jnp.asarray(q.reshape(B * K, G, D)),
        jnp.asarray(k.transpose(0, 2, 1, 3).reshape(B * K, S, D)),
        jnp.asarray(v.transpose(0, 2, 1, 3).reshape(B * K, S, D)),
        jnp.asarray(np.repeat(valid, K, axis=0))))
    ref = torch.tensor(ref).reshape(B, K * G, D)
    assert (got - plain).abs().max().item() <= EMU_TOL, mode
    assert (got - ref).abs().max().item() <= EMU_TOL, mode


def test_the_modes_reach_what_they_are_there_for():
    """window_long: whole splits masked on both sides of splits with work,
    at head_dim 256 and G = 2 (four keys a stage); no_valid_row: a row with
    no valid key over three splits, beside rows with one; windowed_sink:
    the first four splits empty; gqa: scattered valid keys, so some stages
    hold invalid keys and some slices start past their first key;
    irregular_s: one split of 12 keys."""
    q, k, v, valid = decode_dense_case("window_long")
    _, parts = emulated_decode(*to_torch((q, k, v, valid)),
                               return_parts=True)
    for got in parts.values():
        empty = [p is None for p in got]
        assert len(got) == 5 and empty[0] and empty[-1]
        assert sum(not e for e in empty) >= 3
    assert stage_keys(256, block_rows(2, 256)) == 4
    q, k, v, valid = decode_dense_case("no_valid_row")
    _, parts = emulated_decode(*to_torch((q, k, v, valid)),
                               return_parts=True)
    assert not valid[0].any() and valid[1:].any(axis=1).all()
    assert all(p is None for p in parts[0, 0, 0]) and len(parts[0, 0, 0]) == 3
    _, parts = emulated_decode(*to_torch(decode_dense_case("windowed_sink")),
                               return_parts=True)
    assert all(all(p is None for p in got[:4]) for got in parts.values())
    valid = decode_dense_case("gqa")[3]
    assert 0 < valid[:, :SLICE].mean() < 1
    assert any(not row[sl] and row[sl:sl + SLICE].any()
               for row in valid for sl in range(0, valid.shape[1], SLICE))
    assert DECODE_DENSE_MODES["irregular_s"][1] < SPLIT_KEYS


def test_an_empty_split_contributes_exactly_nothing():
    """An empty state absorbed before or after another leaves it bit for
    bit (the warps' merge); in the merge of the splits, empty partials
    after the last (a chunk's tail or whole chunks) leave the output bit for
    bit; and no K or V row of an invalid key is read: NaN there changes no
    bit of a row that has a valid key."""
    q, k, v, valid = decode_dense_case("window_long")
    _, parts = emulated_decode(*to_torch((q, k, v, valid)),
                               return_parts=True)
    got = parts[0, 0, 0]
    one = next(p for p in got if p is not None)
    empty = empty_state(*one[2].shape)
    for state in (absorb(empty, one), absorb(one, empty)):
        assert all(torch.equal(x, y) for x, y in zip(state, one))
    D = one[2].shape[1]
    want = merge_splits(got, D)
    for n in range(1, 2 * merge_chunk(D) + 1):
        more = merge_splits(got + [None] * n, D)
        assert all(torch.equal(x, y) for x, y in zip(more, want)), n
    base = emulated_decode(*to_torch((q, k, v, valid)))
    k, v = k.copy(), v.copy()
    k[valid == 0], v[valid == 0] = np.nan, np.nan
    assert torch.equal(emulated_decode(*to_torch((q, k, v, valid))), base)


@pytest.mark.parametrize("mode", ["window_long", "windowed_sink", "gqa",
                                  "irregular_s"])
def test_bits_do_not_depend_on_trailing_keys_or_the_batch(mode):
    """256 invalid positions with random K and V appended to the cache (two
    more splits, a longer last split; irregular_s goes from one split to
    three) give the same bits; so does each row emulated alone."""
    q, k, v, valid = decode_dense_case(mode)
    base = emulated_decode(*to_torch((q, k, v, valid)))
    rng = np.random.default_rng(1)
    B, S, K, D = k.shape
    tail = lambda a: np.concatenate([a, rng.standard_normal(
        (B, 256, K, D)).astype(np.float32)], 1)
    wide = emulated_decode(*to_torch((q, tail(k), tail(v), np.concatenate(
        [valid, np.zeros((B, 256), np.int8)], 1))))
    assert torch.equal(wide, base), mode
    for b in range(B):
        alone = emulated_decode(*to_torch((q[b:b + 1], k[b:b + 1],
                                           v[b:b + 1], valid[b:b + 1])))
        assert torch.equal(alone[0], base[b]), (mode, b)

"""The port on the card (marker ``gpu``; skips where there is no CUDA
device). Imports no JAX: run it on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Each CUDA kernel, launched through its wrapper, against its plain version
on the same device inputs, over every launch mode below. The launch modes
and their inputs, made with numpy from a seed, are shared with the CPU
parity tests (test_torch_paged_kernels.py, test_torch_dense_kernels.py,
test_torch_ssm_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import ops as dense_dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_decode_attention import ops as dec_ops
from repro_torch.kernels.paged_prefill_attention import ops as pre_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

GPU_TOL = 1e-4    # fp32 kernel vs plain version: another summation order
# SSD scan: sums over N + l terms reach tens, so the same 1e-4 is taken
# relative to the output's largest magnitude (at least 1)
SSD_TOL = 1e-4

# name -> (B, K, G, D, ps, MP, pages_bound, pages_start, window)
DECODE_MODES = {
    "full_walk": (3, 2, 1, 32, 8, 4, None, 0, 0),
    "live_bound": (3, 2, 2, 32, 8, 6, 3, 0, 0),
    "gqa": (2, 2, 8, 16, 8, 3, None, 0, 0),
    "head_dim_24": (3, 2, 1, 24, 16, 3, None, 0, 0),
    "window_late_start": (3, 2, 2, 16, 8, 6, 5, 1, 8),
    # what the split page walk makes distinct (splits of 128 keys, up to 8
    # rows a block): G = 1 over several splits, the last slot idle; ps = 8
    # with lengths at split edges (DECODE_LENS); a window that crosses split
    # boundaries (head_dim 50: 4-byte loads, 2 columns a lane); G = 12 in
    # two row blocks of 8 (the second with 4 rows of padding; head_dim 64:
    # 8-byte loads); head_dim 256 at G = 2 (gemma3-4b's heads); head_dim 98
    # (4-byte loads, 4 columns a lane) at G = 3 (a padding row)
    "split_walk_idle": (8, 2, 1, 32, 16, 24, None, 0, 0),
    "page8_split_edges": (7, 2, 1, 16, 8, 40, 33, 0, 0),
    "window_across_splits": (3, 2, 2, 50, 8, 60, None, 3, 200),
    "rows_past_8": (3, 2, 12, 64, 16, 20, None, 0, 0),
    "head_dim_256_g2": (3, 2, 2, 256, 16, 20, None, 0, 0),
    "head_dim_98": (3, 2, 3, 98, 16, 20, 12, 0, 0),
    # gemma3-4b's local layers: 4 kv heads of 256, G = 2, a window across
    # splits walked from page 5, inside the first 128-key split
    "gemma_window_late_start": (3, 4, 2, 256, 16, 32, None, 5, 300),
}
# decode modes whose lengths are set, not drawn: at the split edges
DECODE_LENS = {"page8_split_edges": [127, 128, 129, 255, 256, 257, 0]}
# name -> (B, K, C, G, D, ps, MP, pages_bound, pages_start, window)
PREFILL_MODES = {
    "full_walk": (3, 2, 4, 1, 32, 8, 4, None, 0, 0),
    "live_bound": (3, 2, 4, 2, 32, 8, 6, 3, 0, 0),
    "gqa": (2, 2, 4, 8, 16, 8, 3, None, 0, 0),
    "head_dim_24": (3, 2, 5, 1, 24, 16, 3, None, 0, 0),
    "window_late_start": (3, 2, 4, 2, 16, 8, 6, 5, 1, 8),
    # what the split page walk makes distinct (splits of 128 keys): G = 1
    # over several splits, ragged, the last slot idle; ps = 8 with chunks
    # across the first split boundary (PREFILL_TOTALS); a window that
    # crosses split boundaries; C * G > 16 in 32-row blocks (4-byte copies
    # at head_dim 18) and in a 64-row block with 28 rows of padding;
    # head_dim 256 with 64 rows (16-key tiles)
    "split_walk": (8, 2, 4, 1, 32, 16, 24, None, 0, 0),
    "page8_split_edge": (4, 2, 4, 1, 16, 8, 20, 18, 0, 0),
    "window_splits": (3, 2, 4, 2, 16, 8, 40, None, 3, 40),
    "rows_past_16": (3, 2, 5, 4, 18, 8, 12, None, 0, 0),
    "rows_64": (3, 1, 6, 6, 40, 16, 12, 9, 0, 0),
    "head_dim_256": (2, 1, 8, 8, 256, 16, 12, None, 0, 0),
    # gemma3-4b's local layers at the pool's 16-token chunk: 4 kv heads of
    # 256, G = 2 (32-row blocks), a window walked from page 5
    "gemma_window_late_start": (3, 4, 16, 2, 256, 16, 32, None, 5, 300),
}
# modes whose totals are set, not drawn: chunks that end just past the
# first split boundary (key 128)
PREFILL_TOTALS = {"page8_split_edge": [130, 128, 129, 0]}

# Dense-cache kernels, covering the launch modes of
# repro/analysis/pallas_check.py::_probe_flash and ::_probe_decode: causal,
# causal with a window, non-causal, irregular S, G > 1 and S not a
# multiple of the CUDA kernels' tiles (flash attention: 128 query rows, 32
# keys); for flash attention also head_dim 20 (zero-padded to 8 in the
# kernel) and 256 (the largest tiles in shared memory).
# name -> (B, S, H, K, D, causal, window)
FLASH_MODES = {
    "causal": (2, 16, 2, 2, 8, True, 0),
    "causal_window": (2, 16, 2, 2, 8, True, 4),
    "non_causal": (2, 16, 2, 2, 8, False, 0),
    "irregular_s": (2, 12, 2, 2, 8, True, 0),
    "gqa": (2, 40, 4, 2, 16, True, 0),
    "long_window": (1, 150, 2, 1, 32, True, 37),
    "non_causal_window": (1, 70, 2, 2, 16, False, 9),
    "head_dim_24": (2, 70, 2, 2, 24, True, 0),
    "head_dim_20": (2, 37, 2, 2, 20, True, 0),
    "head_dim_256": (1, 24, 2, 1, 256, True, 0),
    # gemma3-4b's local layers: windowed, head_dim 256, G = 2
    "gemma_window": (1, 150, 4, 2, 256, True, 37),
}
# name -> (B, S, K, G, D, validity layout)
DECODE_DENSE_MODES = {
    "prefix": (2, 16, 2, 2, 8, "prefix"),
    "irregular_s": (2, 12, 2, 2, 8, "prefix"),
    "mha": (3, 40, 4, 1, 16, "prefix"),
    "gqa": (2, 40, 2, 4, 16, "random"),
    "head_dim_24": (2, 70, 2, 1, 24, "prefix"),
    # the windowed (attention-sink) layout at a position where every sink
    # key is masked: the first 512 keys, a whole TPU key block, are invalid
    "windowed_sink": (2, 600, 2, 2, 16, "late_window"),
    # what the CUDA kernel's split walk (128-key splits) makes distinct: a
    # 250-key window in the middle of the cache with whole splits masked on
    # both sides, at gemma3-4b's head_dim 256 and G = 2 (its local layers);
    # a row with no valid key at all over 3 splits (S <= 512, so the TPU
    # kernel does not pad it)
    "window_long": (2, 600, 2, 2, 256, "window"),
    "no_valid_row": (3, 300, 2, 2, 64, "no_valid_row"),
}


# SSD chunk scan (K3), covering the shapes of tests/test_kernels.py::
# test_ssd_kernel_sweep and the main paths' launch modes: one position
# (the pool's one-token tail), 4 and 16 (the pool's bucketed chunks), 100
# (not a multiple of the CUDA tiles) and 256 (the dense path's chunk) at
# mamba2-130m's widths (P 64, N 128); padding with dt = 0 (a ragged row and
# a whole n_new = 0 row); steep dA, whose exp(dA_i - dA_j) overflows above
# the diagonal. name -> (BC, H, l, P, N, layout)
SSD_MODES = {
    "sweep_l16": (4, 2, 16, 8, 8, "random"),
    "sweep_l32": (4, 4, 32, 16, 8, "random"),
    "sweep_l64": (4, 3, 64, 32, 16, "random"),
    "l1": (4, 3, 1, 16, 16, "random"),
    "l4_pad_dt0": (4, 2, 4, 16, 16, "pad"),
    "l16_pad_dt0_mamba": (3, 2, 16, 64, 128, "pad"),
    "steep_dA": (3, 2, 40, 16, 16, "steep"),
    "l100_mamba": (2, 2, 100, 64, 128, "random"),
    "l256_mamba": (1, 2, 256, 64, 128, "random"),
    # what the tensor-core kernel makes distinct: the pool's 2- and
    # 8-position buckets (16-row tiles, 8-key steps), 17 positions (the
    # first chunk past the 16-row tiles), the widest P and N (P 128, N 256;
    # N 256 at P 64, where a block has 16 warps) and a chunk past a 256-key
    # score strip with 3 heads (its strip is recomputed for the second
    # round of heads)
    "l2": (8, 3, 2, 16, 16, "random"),
    "l8_pad_dt0": (4, 2, 8, 32, 16, "pad"),
    "l17_tile_edge": (3, 2, 17, 64, 128, "random"),
    "p128_n256": (2, 2, 40, 128, 256, "random"),
    "n256_p64": (2, 3, 70, 64, 256, "random"),
    "l300_strip_panels": (1, 3, 300, 16, 16, "random"),
}
# pool chunks of n real positions, each padded with dt = 0 to every l
# bucket from the next power of two up to 16 (see ssd_bucket_case)
SSD_BUCKET_LENS = (1, 2, 3, 5, 7)


def ssd_case(name, seed=0):
    """Inputs of one SSD launch mode in the kernel's layout, as numpy
    arrays: x (BC, H, l, P); dt and dA = cumsum(dt A) (BC, H, l, 1), A < 0;
    B, C (BC, l, N). "pad" zeroes dt past the middle of row 0 and on all of
    the last row (packed prefill's padding); "steep" takes dt in [1, 5) and
    A in (-16, -8]."""
    BC, H, l, P, N, layout = SSD_MODES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, H, l, P))
    if layout == "steep":
        dt = rng.uniform(1.0, 5.0, (BC, H, l, 1))
        A = -rng.uniform(8.0, 16.0, (H,))
    else:
        dt = rng.uniform(0.01, 0.2, (BC, H, l, 1))
        A = -rng.uniform(0.5, 2.0, (H,))
    if layout == "pad":
        dt[0, :, l // 2:] = 0.0
        dt[-1] = 0.0
    da = np.cumsum(dt * A[None, :, None, None], axis=2)
    B = rng.standard_normal((BC, l, N))
    C = rng.standard_normal((BC, l, N))
    return [a.astype(np.float32) for a in (x, dt, da, B, C)]


def ssd_bucket_case(n, l, seed=0, BC=8, H=4, P=64, N=128):
    """A packed pool prefill in the model layout, as numpy arrays: xs
    (BC, 1, l, H, P), dts and dA (BC, 1, l, H), Bs and Cs (BC, 1, l, N).
    Each row's first n positions are the same for every bucket l >= n;
    the padding past n has dt = 0 (so dA stays put) and x, B and C drawn
    afresh for each l, as a packed dispatch pads a chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, 1, n, H, P))
    dt = rng.uniform(0.01, 0.2, (BC, 1, n, H))
    A = -rng.uniform(0.5, 2.0, (H,))
    B = rng.standard_normal((BC, 1, n, N))
    C = rng.standard_normal((BC, 1, n, N))
    pad = np.random.default_rng((seed, l))
    grow = lambda a: np.concatenate(
        [a, pad.standard_normal(a.shape[:2] + (l - n,) + a.shape[3:])], 2)
    x, B, C = grow(x), grow(B), grow(C)
    dt = np.concatenate([dt, np.zeros((BC, 1, l - n, H))], 2)
    da = np.cumsum(dt * A, axis=2)
    return [a.astype(np.float32) for a in (x, dt, da, B, C)]


def ssd_buckets(n):
    """The pool's l buckets a chunk of n real positions may be padded to."""
    b = 1
    while b < n:
        b *= 2
    return [l for l in (1, 2, 4, 8, 16) if l >= b]


def ssd_err(got, want):
    """Max abs error, over the tolerance's scale max(1, max |want|)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max()
                                                 .item())


def flash_case(name, seed=0):
    """Inputs of one flash-attention mode in the model layout: q (B, S, H,
    D) pre-scaled, k and v (B, S, K, D), as numpy arrays, and the static
    keyword arguments."""
    B, S, H, K, D, causal, window = FLASH_MODES[name]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return (q, k, v), dict(causal=causal, window=window)


def decode_dense_case(name, seed=0):
    """Inputs of one dense decode mode in the production layout: q (B, H,
    D) pre-scaled, the raw cache k and v (B, S, K, D) and valid (B, S)
    int8, as numpy arrays. Every row has at least one valid key, as on the
    decode path (the key at the current position), but the first row of
    "no_valid_row", which has none: the TPU kernel, both refs and the plain
    version give it the mean of V over its S keys. "window" rows see a
    250-key window starting at key 140-199."""
    B, S, K, G, D, layout = DECODE_DENSE_MODES[name]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, K * G, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    pos = np.arange(S)[None]
    if layout == "prefix":
        valid = pos <= rng.integers(0, S, (B, 1))
    elif layout == "random":
        valid = rng.random((B, S)) < 0.6
        valid[:, -1] = True
    elif layout == "window":
        lo = rng.integers(140, 200, (B, 1))
        valid = (pos >= lo) & (pos < lo + 250)
    elif layout == "no_valid_row":
        valid = pos <= rng.integers(0, S, (B, 1))
        valid[0] = False
    else:
        valid = pos >= rng.integers(512, S, (B, 1))
    return q, k, v, valid.astype(np.int8)


def _pool(rng, B, K, D, ps, MP, totals):
    """Random pool + a page table giving each request distinct pages
    covering ``totals[b]`` tokens (page 0 is the scratch page)."""
    n_pages = 1 + sum(-(-int(t) // ps) for t in totals)
    kp = rng.standard_normal((n_pages, ps, K, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, K, D)).astype(np.float32)
    pt = np.zeros((B, MP), np.int32)
    nxt = 1
    for b in range(B):
        for i in range(-(-int(totals[b]) // ps)):
            pt[b, i] = nxt
            nxt += 1
    return kp, vp, pt


def decode_case(name, seed=0):
    """Inputs of one decode launch mode, as numpy arrays. The last slot is
    idle (length 0) wherever the mode lets it be."""
    B, K, G, D, ps, MP, bound, pstart, window = DECODE_MODES[name]
    rng = np.random.default_rng(seed)
    hi = (bound or MP) * ps
    lo = pstart * ps + window if window else 1
    lens = rng.integers(lo, hi + 1, (B,)).astype(np.int32)
    if name in DECODE_LENS:
        lens = np.asarray(DECODE_LENS[name], np.int32)
    if not window:
        lens[-1] = 0
    q = (rng.standard_normal((B, K, G, D)) * D ** -0.5).astype(np.float32)
    kp, vp, pt = _pool(rng, B, K, D, ps, MP, lens)
    kw = dict(pages_bound=bound, pages_start=pstart, window=window)
    return (q, kp, vp, pt, lens), kw


def prefill_case(name, seed=0):
    """Inputs of one prefill launch mode: ragged chunks that start mid
    context (start > 0) and fill fewer rows than the chunk width
    (n_new < C), with the last slot idle (total 0) where the mode lets
    it be."""
    B, K, C, G, D, ps, MP, bound, pstart, window = PREFILL_MODES[name]
    rng = np.random.default_rng(seed)
    hi = (bound or MP) * ps
    # under a window every row's earliest in-window key is past the walk
    # start: start - window + 1 >= pages_start * ps
    lo = pstart * ps + window + C if window else C
    total = rng.integers(lo, hi + 1, (B,)).astype(np.int32)
    if name in PREFILL_TOTALS:
        total = np.asarray(PREFILL_TOTALS[name], np.int32)
    n_new = rng.integers(1, C, (B,)).astype(np.int32)         # < C
    start = (total - n_new).astype(np.int32)
    if not window:
        total[-1] = start[-1] = 0
    q = (rng.standard_normal((B, K, C, G, D)) * D ** -0.5).astype(np.float32)
    kp, vp, pt = _pool(rng, B, K, D, ps, MP, total)
    kw = dict(pages_bound=bound, pages_start=pstart, window=window)
    return (q, kp, vp, pt, start, total), kw


def to_torch(arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(set(DECODE_MODES) & set(PREFILL_MODES)))
def test_cuda_kernels_match_plain_versions(mode, cuda):
    """Both CUDA kernels, launched through their wrappers on the card,
    against the plain versions on the same device inputs."""
    for case, op, ref in (
            (decode_case, dec_ops.paged_decode_attention_gqa,
             dec_ops.paged_decode_attention_ref),
            (prefill_case, pre_ops.paged_prefill_attention_gqa,
             pre_ops.paged_prefill_attention_ref)):
        args, kw = case(mode)
        dev = to_torch(args, cuda)
        n0 = op.launches
        got = op(*dev, **kw)
        torch.cuda.synchronize()
        assert op.launches == n0 + 1
        want = ref(*dev, **kw)
        err = (got - want).abs().max().item()
        assert err <= GPU_TOL, (mode, op.__name__, err)
        if not kw["window"]:
            assert not got[-1].any(), "an idle slot must give exactly 0"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(set(PREFILL_MODES) - set(DECODE_MODES)))
def test_cuda_prefill_split_modes_match_plain_version(mode, cuda):
    """The paged prefill kernel's launch modes that decode has no
    counterpart of (the split walk's), against the plain version."""
    args, kw = prefill_case(mode)
    dev = to_torch(args, cuda)
    op = pre_ops.paged_prefill_attention_gqa
    n0 = op.launches
    got = op(*dev, **kw)
    torch.cuda.synchronize()
    assert op.launches == n0 + 1
    err = (got - pre_ops.paged_prefill_attention_ref(*dev, **kw)).abs() \
        .max().item()
    assert err <= GPU_TOL, (mode, err)
    if not kw["window"]:
        assert not got[-1].any(), "an idle slot must give exactly 0"


def _needed_pages(total, ps):
    return max(1, -(-int(total.max()) // ps))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(set(DECODE_MODES) - set(PREFILL_MODES)))
def test_cuda_decode_split_modes_match_plain_version(mode, cuda):
    """The paged decode kernel's launch modes that prefill has no
    counterpart of (the split walk's), against the plain version."""
    args, kw = decode_case(mode)
    dev = to_torch(args, cuda)
    op = dec_ops.paged_decode_attention_gqa
    n0 = op.launches
    got = op(*dev, **kw)
    torch.cuda.synchronize()
    assert op.launches == n0 + 1
    err = (got - dec_ops.paged_decode_attention_ref(*dev, **kw)).abs() \
        .max().item()
    assert err <= GPU_TOL, (mode, err)
    if not kw["window"]:
        assert not got[-1].any(), "an idle slot must give exactly 0"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["split_walk_idle", "page8_split_edges",
                                  "window_across_splits", "rows_past_8"])
def test_cuda_decode_live_walk_is_bitwise_static_walk(mode, cuda):
    """The same inputs under pages_bound = the pages needed and under the
    full table width give bit-identical outputs: a block's work depends on
    its slot's own len, not on the grid."""
    args, kw = decode_case(mode)
    q, kp, vp, pt, lens = to_torch(args, cuda)
    op = dec_ops.paged_decode_attention_gqa
    need = max(kw["pages_start"] + 1, _needed_pages(args[4], kp.shape[1]))
    live = op(q, kp, vp, pt, lens, pages_start=kw["pages_start"],
              window=kw["window"], pages_bound=need)
    full = op(q, kp, vp, pt, lens, pages_start=kw["pages_start"],
              window=kw["window"], pages_bound=None)
    torch.cuda.synchronize()
    assert torch.equal(live, full), mode


@pytest.mark.gpu
@pytest.mark.parametrize("modes", [
    ("window_late_start", "window_late_start"),
    ("window_across_splits", "window_splits"),
    ("gemma_window_late_start", "gemma_window_late_start")],
    ids=lambda m: m[0])
def test_cuda_window_walk_start_is_bitwise(modes, cuda):
    """A window walk gives the same bits from page 0 and from a late first
    page that still covers every row's window (the engine's
    ``_window_start``), in both paged kernels (decode mode, prefill mode):
    which keys a block sums depends on the window, not on where the walk
    starts. The engine's live and static walks rest on this."""
    for mode, case, op in ((modes[0], decode_case,
                            dec_ops.paged_decode_attention_gqa),
                           (modes[1], prefill_case,
                            pre_ops.paged_prefill_attention_gqa)):
        args, kw = case(mode)
        dev = to_torch(args, cuda)
        assert kw["pages_start"] > 0 and kw["window"] > 0
        late = op(*dev, **kw)
        first = op(*dev, **dict(kw, pages_start=0))
        torch.cuda.synchronize()
        assert torch.equal(late, first), (mode, op.__name__)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["split_walk_idle", "rows_past_8"])
def test_cuda_decode_slot_alone_is_bitwise_packed(mode, cuda):
    """Each slot launched alone, at its own live bound, gives the bits it
    gets in the packed launch of every slot (8 in split_walk_idle)."""
    args, kw = decode_case(mode)
    q, kp, vp, pt, lens = to_torch(args, cuda)
    op = dec_ops.paged_decode_attention_gqa
    packed = op(q, kp, vp, pt, lens, **kw)
    ps = kp.shape[1]
    for b in range(q.shape[0]):
        own = dict(kw, pages_bound=max(kw["pages_start"] + 1, _needed_pages(
            args[4][b:b + 1], ps)))
        alone = op(q[b:b + 1], kp, vp, pt[b:b + 1], lens[b:b + 1], **own)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], packed[b]), (mode, b)


@pytest.mark.gpu
def test_cuda_decode_launch_zeroes_its_split_counts(cuda):
    """The paged decode launch zeroes its counts of finished splits itself:
    over a workspace whose every byte is 0xff (every count non-zero), the
    kernel still merges every row block's splits and matches the plain
    version."""
    args, kw = decode_case("split_walk_idle")
    q, kp, vp, pt, lens = to_torch(args, cuda)
    B, K, G, D = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    end = MP if kw["pages_bound"] is None else kw["pages_bound"]
    name = dec_ops.NAME
    n = common.query(name, "paged_decode_workspace_bytes", B, K, G, D, ps,
                     kw["pages_start"], end)
    assert n > 0, "the case must span more than one split"
    ws = torch.full((n,), 0xFF, dtype=torch.uint8, device=q.device)
    out = torch.full_like(q, float("nan"))
    common.launch(name, "paged_decode_attention_f32", q, kp, vp, pt, lens,
                  out, ws, B, K, G, D, ps, MP, kw["pages_start"], end,
                  kw["window"])
    torch.cuda.synchronize()
    want = dec_ops.paged_decode_attention_ref(q, kp, vp, pt, lens, **kw)
    assert (out - want).abs().max().item() <= GPU_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["split_walk", "page8_split_edge",
                                  "window_splits", "rows_64"])
def test_cuda_prefill_live_walk_is_bitwise_static_walk(mode, cuda):
    """The same inputs under pages_bound = the pages needed and under the
    full table width give bit-identical outputs: a block's work depends on
    its slot's own start and total, not on the grid."""
    args, kw = prefill_case(mode)
    q, kp, vp, pt, start, total = to_torch(args, cuda)
    op = pre_ops.paged_prefill_attention_gqa
    live = op(q, kp, vp, pt, start, total, pages_start=kw["pages_start"],
              window=kw["window"],
              pages_bound=_needed_pages(args[5], kp.shape[1]))
    full = op(q, kp, vp, pt, start, total, pages_start=kw["pages_start"],
              window=kw["window"], pages_bound=None)
    torch.cuda.synchronize()
    assert torch.equal(live, full), mode


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["split_walk", "rows_64"])
def test_cuda_prefill_slot_alone_is_bitwise_packed(mode, cuda):
    """Each slot launched alone, at its own live bound, gives the bits it
    gets in the packed launch of every slot (8 in split_walk)."""
    args, kw = prefill_case(mode)
    q, kp, vp, pt, start, total = to_torch(args, cuda)
    op = pre_ops.paged_prefill_attention_gqa
    packed = op(q, kp, vp, pt, start, total, **kw)
    ps = kp.shape[1]
    for b in range(q.shape[0]):
        own = dict(kw, pages_bound=max(kw["pages_start"] + 1, _needed_pages(
            args[5][b:b + 1], ps)))
        alone = op(q[b:b + 1], kp, vp, pt[b:b + 1], start[b:b + 1],
                   total[b:b + 1], **own)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], packed[b]), (mode, b)


@pytest.mark.gpu
def test_cuda_prefill_launch_zeroes_its_split_counts(cuda):
    """The paged prefill launch zeroes its counts of finished splits
    itself: over a workspace whose every byte is 0xff (every count
    non-zero), the kernel still merges every row block's splits and
    matches the plain version."""
    args, kw = prefill_case("split_walk")
    q, kp, vp, pt, start, total = to_torch(args, cuda)
    B, K, C, G, D = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    end = MP if kw["pages_bound"] is None else kw["pages_bound"]
    name = pre_ops.NAME
    n = common.query(name, "paged_prefill_workspace_bytes", B, K, C, G, D,
                     ps, kw["pages_start"], end)
    assert n > 0, "the case must span more than one split"
    ws = torch.full((n,), 0xFF, dtype=torch.uint8, device=q.device)
    out = torch.full_like(q, float("nan"))
    common.launch(name, "paged_prefill_attention_f32", q, kp, vp, pt, start,
                  total, out, ws, B, K, C, G, D, ps, MP, kw["pages_start"],
                  end, kw["window"])
    torch.cuda.synchronize()
    want = pre_ops.paged_prefill_attention_ref(q, kp, vp, pt, start, total,
                                               **kw)
    assert (out - want).abs().max().item() <= GPU_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(FLASH_MODES))
def test_cuda_flash_attention_matches_plain_version(mode, cuda):
    """The flash-attention kernel through both entries (model layout and
    the TPU kernel's (BH, S, D)) against the plain version on the card,
    and through the model entry on views of rows D + 1 floats wide, whose
    rows are not 16-byte aligned (the kernel's 4-byte copies)."""
    args, kw = flash_case(mode)
    q, k, v = to_torch(args, cuda)
    B, S, H, D = q.shape
    n0 = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == n0 + 1
    bhsd = lambda t: t.repeat_interleave(H // t.shape[2], 2).movedim(2, 1) \
        .reshape(B * H, S, D).contiguous()
    want = flash_ops.attention_ref(bhsd(q), bhsd(k), bhsd(v), **kw)
    err = (got.movedim(2, 1).reshape(B * H, S, D) - want).abs().max().item()
    assert err <= GPU_TOL, (mode, err)
    got = flash_ops.flash_attention_bhsd(bhsd(q), bhsd(k), bhsd(v), **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= GPU_TOL, mode
    wide = [torch.nn.functional.pad(t, (0, 1))[..., :D] for t in (q, k, v)]
    got = flash_ops.flash_attention(*wide, **kw)
    torch.cuda.synchronize()
    err = (got.movedim(2, 1).reshape(B * H, S, D) - want).abs().max().item()
    assert err <= GPU_TOL, (mode, "rows D + 1 apart", err)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(DECODE_DENSE_MODES))
def test_cuda_decode_attention_matches_plain_version(mode, cuda):
    """The dense decode kernel through its three entries against the plain
    version on the card; the production entry reads a strided cache."""
    q, k, v, valid = to_torch(decode_dense_case(mode), cuda)
    B, S, K, D = k.shape
    G = q.shape[1] // K
    qg = q.reshape(B * K, G, D)
    kg, vg = (t.movedim(2, 1).reshape(B * K, S, D).contiguous()
              for t in (k, v))
    vmask = valid.repeat_interleave(K, 0)
    want = dense_dec_ops.decode_attention_ref(qg, kg, vg, vmask)
    # a cache slab one position wider, read through its strides in place
    wide = torch.zeros((2, B, S + 1, K, D), device=cuda)
    wide[0, :, :S], wide[1, :, :S] = k, v
    n0 = dense_dec_ops.decode_attention_kv.launches
    got = dense_dec_ops.decode_attention_kv(q, wide[0, :, :S], wide[1, :, :S],
                                            valid)
    torch.cuda.synchronize()
    assert dense_dec_ops.decode_attention_kv.launches == n0 + 1
    err = (got.reshape(B * K, G, D) - want).abs().max().item()
    assert err <= GPU_TOL, (mode, err)
    got = dense_dec_ops.decode_attention_gqa(qg, kg, vg, vmask)
    assert (got - want).abs().max().item() <= GPU_TOL, mode
    if G == 1:
        got = dense_dec_ops.decode_attention(q[:, None], k, v, valid)
        err = (got[:, 0].reshape(B * K, 1, D) - want).abs().max().item()
        assert err <= GPU_TOL, mode
    torch.cuda.synchronize()


def _dense_plain(q, k, v, valid):
    """The dense decode plain version in the production layout: (B, H, D)
    from q (B, H, D), k and v (B, S, K, D), valid (B, S)."""
    B, S, K, D = k.shape
    G = q.shape[1] // K
    return dense_dec_ops.decode_attention_ref(
        q.reshape(B * K, G, D), k.movedim(2, 1).reshape(B * K, S, D),
        v.movedim(2, 1).reshape(B * K, S, D),
        valid.repeat_interleave(K, 0)).reshape(B, K * G, D)


@pytest.mark.gpu
def test_cuda_decode_attention_exact_contracts(cuda):
    """The dense decode kernel's exact contracts, bit for bit: each row
    launched alone gets the bits it gets in the batch, and the rows get the
    same bits with 256 invalid positions (random K and V) appended to the
    cache, which adds two empty splits and lengthens the last. At gemma3-4b's
    local-layer decode (8 rows, 4 kv heads of 256, G = 2, the 1024-key
    window at position 2064 of a 2080-position slab), on window_long and
    on irregular_s (one split grown to three)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S, K, G, D = 8, 2080, 4, 2, 256
    q = torch.randn((B, K * G, D), generator=g, device=cuda) * D ** -0.5
    k = torch.randn((B, S, K, D), generator=g, device=cuda)
    v = torch.randn((B, S, K, D), generator=g, device=cuda)
    pos = torch.arange(S, device=cuda)
    valid = ((pos <= 2064) & (2064 - pos < 1024)).to(torch.int8)
    cases = [("gemma3", (q, k, v, valid[None].expand(B, S).contiguous()))]
    cases += [(m, to_torch(decode_dense_case(m), cuda))
              for m in ("window_long", "irregular_s")]
    op = dense_dec_ops.decode_attention_kv
    for name, (q, k, v, valid) in cases:
        got = op(q, k, v, valid)
        assert (got - _dense_plain(q, k, v, valid)).abs().max().item() \
            <= GPU_TOL, name
        for b in range(q.shape[0]):
            alone = op(q[b:b + 1], k[b:b + 1], v[b:b + 1], valid[b:b + 1])
            torch.cuda.synchronize()
            assert torch.equal(alone[0], got[b]), (name, b)
        B, S, K, D = k.shape
        tail = lambda t: torch.cat([t, torch.randn(
            (B, 256, K, D), generator=g, device=cuda)], 1)
        longer = torch.cat([valid, torch.zeros(
            (B, 256), dtype=torch.int8, device=cuda)], 1)
        wide = op(q, tail(k), tail(v), longer)
        torch.cuda.synchronize()
        assert torch.equal(wide, got), name


@pytest.mark.gpu
def test_cuda_decode_attention_launch_zeroes_its_split_counts(cuda):
    """The dense decode launch zeroes its counts of finished splits itself:
    over a workspace whose every byte is 0xff (every count non-zero), the
    kernel still merges every row block's splits and matches the plain
    version."""
    q, k, v, valid = to_torch(decode_dense_case("window_long"), cuda)
    B, S, K, D = k.shape
    G = q.shape[1] // K
    name = dense_dec_ops.NAME
    n = common.query(name, "decode_attention_workspace_bytes", B, S, K, G, D)
    assert n > 0, "the case must span more than one split"
    ws = torch.full((n,), 0xFF, dtype=torch.uint8, device=cuda)
    out = torch.full_like(q, float("nan"))
    common.launch(name, "decode_attention_f32", q, k, v, valid, out, ws, B,
                  S, K, G, D, *k.stride()[:3])
    torch.cuda.synchronize()
    err = (out - _dense_plain(q, k, v, valid)).abs().max().item()
    assert err <= GPU_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(SSD_MODES))
def test_cuda_ssd_chunk_scan_matches_plain_version(mode, cuda):
    """The SSD chunk kernel through both entries (the TPU kernel's layout,
    and the model's layout read and written through strides) against the
    plain versions on the card. A whole row of dt = 0 gives a state of
    exactly 0, and steep dA gives finite outputs."""
    x, dt, da, B, C = to_torch(ssd_case(mode), cuda)
    n0 = ssd_ops.ssd_chunk_scan.launches
    y, st = ssd_ops.ssd_chunk_scan(x, dt, da, B, C)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == n0 + 1
    y_ref, st_ref = ssd_ops.ssd_chunk_ref(x, dt, da, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(st).all(), mode
    assert ssd_err(y, y_ref) <= SSD_TOL, (mode, ssd_err(y, y_ref))
    assert ssd_err(st, st_ref) <= SSD_TOL, (mode, ssd_err(st, st_ref))
    if SSD_MODES[mode][-1] == "pad":
        assert not st[-1].any(), "a dt = 0 row must add exactly 0"
    # the model layout: (b, nc, l, H, P) with b * nc = BC
    BC, H, l, P = x.shape
    b = 2 if BC % 2 == 0 else 1
    xs = x.movedim(1, 2).reshape(b, BC // b, l, H, P)
    dts, das = (t[..., 0].movedim(1, 2).reshape(b, BC // b, l, H)
                .contiguous() for t in (dt, da))
    Bs, Cs = (t.reshape(b, BC // b, l, -1) for t in (B, C))
    yd, states = ssd_ops.ssd_chunk(xs, dts, das, Bs, Cs)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == n0 + 2
    yd_ref, states_ref = ssd_ops.ssd_chunk_reference(xs, dts, das, Bs, Cs)
    assert ssd_err(yd, yd_ref) <= SSD_TOL, mode
    assert ssd_err(states, states_ref) <= SSD_TOL, mode


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 2, 8, 16, 17, 256])
def test_cuda_ssd_bc_alone_is_bitwise_packed(l, cuda):
    """Each bc of a packed launch (8 chunks, both entries) gives the same
    bits as the same chunk launched alone: no sum depends on BC."""
    case = ssd_bucket_case(l, l, seed=l)
    x, dt, da, B, C = model = to_torch(case, cuda)
    packed = ssd_ops.ssd_chunk(*model)
    # the same chunks in the TPU kernel's layout
    x_, dt_, da_ = (a[:, 0].swapaxes(1, 2) for a in case[:3])
    flat = to_torch([a.copy() for a in (x_, dt_[..., None], da_[..., None],
                                        case[3][:, 0], case[4][:, 0])], cuda)
    packed_tpu = ssd_ops.ssd_chunk_scan(*flat)
    for k in range(x.shape[0]):
        alone = ssd_ops.ssd_chunk(*(t[k:k + 1] for t in model))
        alone_tpu = ssd_ops.ssd_chunk_scan(*(t[k:k + 1] for t in flat))
        for got, want in zip(alone + alone_tpu, packed + packed_tpu):
            assert torch.equal(got[0], want[k]), (l, k)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", SSD_BUCKET_LENS)
def test_cuda_ssd_buckets_are_bitwise_equal(n, cuda):
    """A chunk of n real positions padded with dt = 0 (and other x, B, C
    past n) to each l bucket of the pool gives the same bits in its n rows
    of y and in its state: the padding adds exact zeros, and every sum
    runs over the same 8-key steps at the same absolute positions."""
    outs = []
    for l in ssd_buckets(n):
        y, st = ssd_ops.ssd_chunk(*to_torch(ssd_bucket_case(n, l), cuda))
        outs.append((l, y[:, :, :n], st))
    torch.cuda.synchronize()
    for l, y, st in outs[1:]:
        assert torch.equal(y, outs[0][1]), (n, l)
        assert torch.equal(st, outs[0][2]), (n, l)


# ------------------------------------------------------------- training
STEP_RTOL = 1e-4   # one training step, card vs CPU: loss and grad norm


def _step_card_vs_cpu(make_module, make_step, batch, cuda):
    """One training step from the same weights and batch on the CPU and on
    the card: [cpu metrics, card metrics], loss and grad norm as floats.
    ``batch`` is a tuple of tensors and dicts of tensors."""
    from repro_torch.training.optim import init_opt_state
    from repro_torch.training.trainer import trainable
    to = lambda t, dev: {k: v.to(dev) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(dev)
    cpu_model = make_module()
    card_model = make_module().to(cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    out = []
    for model, dev in ((cpu_model, "cpu"), (card_model, cuda)):
        step, ocfg = make_step()
        with trainable(model):
            m = step(model, init_opt_state(dict(model.named_parameters()),
                                           ocfg),
                     *[to(t, dev) for t in batch])[2]
        torch.cuda.synchronize()
        out.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return out


@pytest.mark.gpu
def test_cuda_router_train_step_matches_cpu(cuda):
    from repro_torch.core import router
    from repro_torch.data import tokenizer as tok
    from repro_torch.data.tasks import generate_dataset
    from repro_torch.models.encoder import RouterConfig, init_router_encoder
    from repro_torch.training.optim import AdamWConfig
    rcfg = RouterConfig(vocab_size=tok.VOCAB_SIZE, n_layers=2, d_model=64,
                        n_heads=4, d_ff=256)
    ds = generate_dataset(np.random.default_rng(0), 32)
    y = np.random.default_rng(1).uniform(size=32).astype(np.float32)
    ocfg = AdamWConfig()
    cpu, card = _step_card_vs_cpu(
        lambda: init_router_encoder(rcfg, torch.Generator().manual_seed(0),
                                    "cpu"),
        lambda: (router.make_train_step(rcfg, ocfg), ocfg),
        (torch.tensor(ds.query).long(), torch.tensor(ds.query_mask),
         torch.tensor(y)), cuda)
    for k in cpu:
        assert abs(card[k] - cpu[k]) <= STEP_RTOL * abs(cpu[k]), (k, cpu, card)


@pytest.mark.gpu
def test_cuda_lm_train_step_matches_cpu(cuda):
    from repro_torch.core.experiment import TIERS
    from repro_torch.data.tasks import generate_dataset, lm_training_arrays
    from repro_torch.models.model import build_model
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.trainer import make_lm_train_step
    cfg = TIERS["large"][0]   # head_dim 24
    bundle = build_model(cfg)
    arrays = lm_training_arrays(generate_dataset(np.random.default_rng(2),
                                                 16))
    ocfg = AdamWConfig()
    cpu, card = _step_card_vs_cpu(
        lambda: bundle.init(torch.Generator().manual_seed(1), "cpu"),
        lambda: (make_lm_train_step(bundle, ocfg), ocfg),
        ({k: torch.tensor(v) for k, v in arrays.items()},), cuda)
    for k in cpu:
        assert abs(card[k] - cpu[k]) <= STEP_RTOL * abs(cpu[k]), (k, cpu, card)


@pytest.mark.gpu
def test_cuda_cascade_pool_launches_paged_kernels(cuda):
    """A 3-tier shared-score CascadePolicy over three of the pipeline's
    tiers: every tier receives queries, and each launches both paged
    kernels on the card; the pool dispatches as the policy decides and
    leaks no page."""
    from repro_torch.core.experiment import TIERS
    from repro_torch.core.routing import CascadePolicy, HybridRouter
    from repro_torch.data import tokenizer as tok
    from repro_torch.data.tasks import generate_dataset
    from repro_torch.models.encoder import RouterConfig, init_router_encoder
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.pool import ContinuousPoolEngine
    rcfg = RouterConfig(vocab_size=tok.VOCAB_SIZE, n_layers=1, d_model=32,
                        n_heads=2, d_ff=64)
    r = HybridRouter(init_router_encoder(
        rcfg, torch.Generator(device=cuda).manual_seed(0), cuda), rcfg, 0.0)
    ds = generate_dataset(np.random.default_rng(3), 24)
    s = np.sort(r.scores(ds.query, ds.query_mask).cpu().numpy())
    policy = CascadePolicy(r, (float(s[15] + s[16]) / 2,
                               float(s[7] + s[8]) / 2))
    names = ("small", "medium", "large")
    engines, per_tier = [], {}
    for i, name in enumerate(names):
        bundle = build_model(TIERS[name][0])
        eng = ContinuousEngine(bundle, bundle.init(
            torch.Generator(device=cuda).manual_seed(i), cuda),
            max_new_tokens=6, n_slots=4, max_seq=64)
        per_tier[name] = [0, 0]

        def counted(step=eng.step, name=name):
            d0 = dec_ops.paged_decode_attention_gqa.launches
            p0 = pre_ops.paged_prefill_attention_gqa.launches
            out = step()
            per_tier[name][0] += dec_ops.paged_decode_attention_gqa.launches \
                - d0
            per_tier[name][1] += pre_ops.paged_prefill_attention_gqa.launches \
                - p0
            return out
        eng.step = counted
        engines.append((name, eng))
    pool = ContinuousPoolEngine(policy, engines)
    res = pool.serve(ds.query, ds.query_mask)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(res.tier_idx,
                                  policy.decide(ds.query, ds.query_mask)[0])
    assert np.bincount(res.tier_idx, minlength=3).tolist() == [8, 8, 8]
    assert pool.meter.total_calls == 24 and (res.lengths >= 1).all()
    for name, eng in engines:
        assert per_tier[name][0] > 0 and per_tier[name][1] > 0, per_tier
        assert eng.cache.free_pages == eng.cache.num_pages - 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["burst", "escalation-storm"])
def test_cuda_fault_scenarios(name, cuda):
    """The port's burst and escalation-storm chaos scenarios on the card,
    through both paged kernels: every invariant holds, and preempted and
    escalated streams emit the tokens of uncontended runs (the scenarios'
    own checks)."""
    from repro_torch.serving import faults
    d0 = dec_ops.paged_decode_attention_gqa.launches
    p0 = pre_ops.paged_prefill_attention_gqa.launches
    h = faults.SCENARIOS[name](verbose=False, device="cuda")
    assert h.check_invariants() == []
    assert dec_ops.paged_decode_attention_gqa.launches > d0
    assert pre_ops.paged_prefill_attention_gqa.launches > p0

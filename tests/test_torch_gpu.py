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
# bf16 kernel vs plain version at bf16 (allclose, rtol = atol): the
# reference's own bf16 tolerance for its kernels against their oracles;
# the plain version rounds scores to bf16, the kernel keeps them in fp32
BF16_TOL = 2e-2
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
# the bf16 design's query tile (one m16 tile of a kv head's G rows): G = 6
# and 12 (internvl2-26b's group, and two full 8-row blocks of the fp32
# design) in one row block, and G = 18 in two (the second with 2 rows)
DECODE_DENSE_GQA_MODES = {
    "gqa_6": (2, 300, 2, 6, 128, "prefix"),
    "gqa_12": (2, 200, 2, 12, 64, "random"),
    "rows_past_16": (1, 150, 2, 18, 32, "prefix"),
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
# jamba-v0.1-52b's shapes, as chip_smoke.py's phase 4g gives the kernels
# (card only: the CPU parity tests keep to the small modes above): its
# attention layer (32 heads over 8 kv heads of 128) in the pool's decode
# (8 slots, pages of 16, contexts up to 544 keys in a 64-page table) and
# 16-token prefill chunks, the dense path's 512-token flash prefill and
# its decode over a 544-position cache; its Mamba layers (128 SSD heads of
# 64, state 16) in the dense path's 128-position chunks (8 prompts of 512)
# and the pool's 16-position chunks with dt = 0 padding
JAMBA_MODES = {
    "paged_decode": (8, 8, 4, 128, 16, 64, 34, 0, 0),
    "paged_prefill": (8, 8, 16, 4, 128, 16, 64, 34, 0, 0),
    "flash": (8, 512, 32, 8, 128, True, 0),
    "dense_decode": (8, 544, 8, 4, 128, "prefix"),
    "ssd_dense": (32, 128, 128, 64, 16, "random"),
    "ssd_pool": (8, 128, 16, 64, 16, "pad"),
}
# the encoder-decoder (whisper-large-v3) and vision-frontend
# (internvl2-26b) shapes, as chip_smoke.py's phase 4h gives the kernels
# (card only): whisper's encoder self-attention (16 prompts of 1500
# frames, 20 heads of 64, non-causal), its decoder's 48-token causal
# prefill, its decode self-attention over an 80-position cache and its
# decode cross-attention over all 1500 encoder keys; internvl2's causal
# prefill over 256 patch + 256 prompt positions (48 heads over 8 kv heads
# of 128, G = 6) and its decode over a 544-position cache
ENCDEC_VLM_MODES = {
    "whisper_encoder_flash": (16, 1500, 20, 20, 64, False, 0),
    "whisper_decoder_flash": (16, 48, 20, 20, 64, True, 0),
    "whisper_self_decode": (16, 80, 20, 1, 64, "prefix"),
    "whisper_cross_decode": (16, 1500, 20, 1, 64, "all"),
    "internvl2_flash": (16, 512, 48, 8, 128, True, 0),
    "internvl2_decode": (16, 544, 8, 6, 128, "prefix"),
}
# pool chunks of n real positions, each padded with dt = 0 to every l
# bucket from the next power of two up to 16 (see ssd_bucket_case)
SSD_BUCKET_LENS = (1, 2, 3, 5, 7)


def ssd_case(name, seed=0, modes=SSD_MODES):
    """Inputs of one SSD launch mode in the kernel's layout, as numpy
    arrays: x (BC, H, l, P); dt and dA = cumsum(dt A) (BC, H, l, 1), A < 0;
    B, C (BC, l, N). "pad" zeroes dt past the middle of row 0 and on all of
    the last row (packed prefill's padding); "steep" takes dt in [1, 5) and
    A in (-16, -8]."""
    BC, H, l, P, N, layout = modes[name]
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


def flash_case(name, seed=0, modes=FLASH_MODES):
    """Inputs of one flash-attention mode in the model layout: q (B, S, H,
    D) pre-scaled, k and v (B, S, K, D), as numpy arrays, and the static
    keyword arguments."""
    B, S, H, K, D, causal, window = modes[name]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return (q, k, v), dict(causal=causal, window=window)


def decode_dense_case(name, seed=0, modes=DECODE_DENSE_MODES):
    """Inputs of one dense decode mode in the production layout: q (B, H,
    D) pre-scaled, the raw cache k and v (B, S, K, D) and valid (B, S)
    int8, as numpy arrays. Every row has at least one valid key, as on the
    decode path (the key at the current position), but the first row of
    "no_valid_row", which has none: the TPU kernel, both refs and the plain
    version give it the mean of V over its S keys. "window" rows see a
    250-key window starting at key 140-199."""
    B, S, K, G, D, layout = modes[name]
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
    elif layout == "all":
        valid = np.ones((B, S), bool)
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


def decode_case(name, seed=0, modes=DECODE_MODES):
    """Inputs of one decode launch mode, as numpy arrays. The last slot is
    idle (length 0) wherever the mode lets it be."""
    B, K, G, D, ps, MP, bound, pstart, window = modes[name]
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


def prefill_case(name, seed=0, modes=PREFILL_MODES):
    """Inputs of one prefill launch mode: ragged chunks that start mid
    context (start > 0) and fill fewer rows than the chunk width
    (n_new < C), with the last slot idle (total 0) where the mode lets
    it be."""
    B, K, C, G, D, ps, MP, bound, pstart, window = modes[name]
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


def _typed(ts, dtype):
    """``ts`` with every float tensor cast to ``dtype``."""
    return [t.to(dtype) if t.is_floating_point() else t for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["split_walk", "page8_split_edge",
                                  "window_splits", "rows_64"])
def test_cuda_prefill_live_walk_is_bitwise_static_walk(mode, dtype, cuda):
    """The same inputs under pages_bound = the pages needed and under the
    full table width give bit-identical outputs: a block's work depends on
    its slot's own start and total, not on the grid. At fp32 and at bf16
    (each dtype its own design)."""
    args, kw = prefill_case(mode)
    q, kp, vp, pt, start, total = _typed(to_torch(args, cuda), dtype)
    op = pre_ops.paged_prefill_attention_gqa
    live = op(q, kp, vp, pt, start, total, pages_start=kw["pages_start"],
              window=kw["window"],
              pages_bound=_needed_pages(args[5], kp.shape[1]))
    full = op(q, kp, vp, pt, start, total, pages_start=kw["pages_start"],
              window=kw["window"], pages_bound=None)
    torch.cuda.synchronize()
    assert torch.equal(live, full), mode


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["split_walk", "rows_64"])
def test_cuda_prefill_slot_alone_is_bitwise_packed(mode, dtype, cuda):
    """Each slot launched alone, at its own live bound, gives the bits it
    gets in the packed launch of every slot (8 in split_walk), at fp32
    and at bf16."""
    args, kw = prefill_case(mode)
    q, kp, vp, pt, start, total = _typed(to_torch(args, cuda), dtype)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_prefill_launch_zeroes_its_split_counts(dtype, cuda):
    """The paged prefill launch zeroes its counts of finished splits
    itself: over a workspace whose every byte is 0xff (every count
    non-zero), the kernel still merges every row block's splits and
    matches the plain version (through the _bf16 entry at bf16, within
    BF16_TOL)."""
    args, kw = prefill_case("split_walk")
    q, kp, vp, pt, start, total = _typed(to_torch(args, cuda), dtype)
    B, K, C, G, D = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    end = MP if kw["pages_bound"] is None else kw["pages_bound"]
    name = pre_ops.NAME
    n = common.query(name, "paged_prefill_workspace_bytes", B, K, C, G, D,
                     ps, kw["pages_start"], end)
    assert n > 0, "the case must span more than one split"
    ws = torch.full((n,), 0xFF, dtype=torch.uint8, device=q.device)
    out = torch.full_like(q, float("nan"))
    common.launch(name, f"paged_prefill_attention_"
                  f"{common.ENTRY_SUFFIX[dtype]}", q, kp, vp, pt, start,
                  total, out, ws, B, K, C, G, D, ps, MP, kw["pages_start"],
                  end, kw["window"])
    torch.cuda.synchronize()
    want = pre_ops.paged_prefill_attention_ref(q, kp, vp, pt, start, total,
                                               **kw)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
    else:
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


def _bf16_cases():
    """(kernel, mode) of every launch mode of K1, K2, K4 and K5."""
    return ([("paged_decode", m) for m in sorted(DECODE_MODES)]
            + [("paged_prefill", m) for m in sorted(PREFILL_MODES)]
            + [("flash", m) for m in sorted(FLASH_MODES)]
            + [("dense_decode", m) for m in sorted(DECODE_DENSE_MODES)])


def _typed_launch(kernel, mode, device, dtypes):
    """(wrapper, its call, the plain version's call) of one launch mode,
    the i-th float input cast to ``dtypes[i]`` (the last entry for the
    rest)."""
    def typed(ts):
        out, i = [], 0
        for t in ts:
            if t.is_floating_point():
                t = t.to(dtypes[min(i, len(dtypes) - 1)])
                i += 1
            out.append(t)
        return out
    if kernel in ("paged_decode", "paged_prefill"):
        case, op, ref = {
            "paged_decode": (decode_case, dec_ops.paged_decode_attention_gqa,
                             dec_ops.paged_decode_attention_ref),
            "paged_prefill": (prefill_case,
                              pre_ops.paged_prefill_attention_gqa,
                              pre_ops.paged_prefill_attention_ref)}[kernel]
        args, kw = case(mode)
        dev = typed(to_torch(args, device))
        return op, lambda: op(*dev, **kw), lambda: ref(*dev, **kw)
    if kernel == "flash":
        args, kw = flash_case(mode)
        q, k, v = typed(to_torch(args, device))
        B, S, H, D = q.shape
        op = flash_ops.flash_attention
        bhsd = lambda t: t.repeat_interleave(H // t.shape[2], 2) \
            .movedim(2, 1).reshape(B * H, S, D)
        return op, lambda: op(q, k, v, **kw), lambda: flash_ops.attention_ref(
            bhsd(q), bhsd(k), bhsd(v), **kw).reshape(B, H, S, D).movedim(1, 2)
    if kernel == "ssd":
        x, dt, da, B, C = typed(to_torch(ssd_case(mode), device))
        op = ssd_ops.ssd_chunk_scan
        return op, lambda: op(x, dt, da, B, C), \
            lambda: ssd_ops.ssd_chunk_ref(x, dt, da, B, C)
    q, k, v, valid = typed(to_torch(decode_dense_case(mode), device))
    op = dense_dec_ops.decode_attention_kv
    return op, lambda: op(q, k, v, valid), \
        lambda: _dense_plain(q, k, v, valid)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,mode", _bf16_cases())
def test_cuda_bf16_kernels_match_plain_versions(kernel, mode, cuda):
    """Each launch mode of K1, K2, K4 and K5 at bf16 on the card: one
    launch of the kernel's bf16 instance (counted under "bfloat16"), a
    bf16 output within BF16_TOL of the plain version at bf16 on the same
    inputs."""
    op, run, plain = _typed_launch(kernel, mode, cuda, [torch.bfloat16])
    n0, b0 = op.launches, op.launches_by_dtype.get("bfloat16", 0)
    got = run()
    torch.cuda.synchronize()
    assert (op.launches, op.launches_by_dtype["bfloat16"]) == (n0 + 1,
                                                               b0 + 1)
    want = plain()
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["paged_decode", "paged_prefill", "flash",
                                    "dense_decode", "ssd"])
@pytest.mark.parametrize("dtypes", [
    [torch.float16], [torch.float32, torch.bfloat16],
    # the SSD scan's x, B and C bf16 with a bf16 dt (dA fp32); the
    # attention kernels' q, k bf16 with an fp32 v
    [torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16]])
def test_cuda_kernels_refuse_other_dtypes(kernel, dtypes, cuda):
    """fp16 inputs, fp32 and bf16 inputs in one launch, or (the SSD scan)
    a dt or dA that is not fp32, raise before any launch; nothing falls
    back to the plain version."""
    mode = "l16_pad_dt0_mamba" if kernel == "ssd" else "gqa"
    op, run, _ = _typed_launch(kernel, mode, cuda, dtypes)
    n0 = op.launches
    with pytest.raises(ValueError, match="mixed|the kernel takes"):
        run()
    assert op.launches == n0


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_exact_contracts(dtype, cuda):
    """The dense decode kernel's exact contracts, bit for bit: each row
    launched alone gets the bits it gets in the batch, and the rows get the
    same bits with 256 invalid positions (random K and V) appended to the
    cache, which adds two empty splits and lengthens the last. At gemma3-4b's
    local-layer decode (8 rows, 4 kv heads of 256, G = 2, the 1024-key
    window at position 2064 of a 2080-position slab), on window_long and
    on irregular_s (one split grown to three), at fp32 and through the
    bf16 design at bf16 (and at G = 6 and 18 there)."""
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
    if dtype == torch.bfloat16:
        cases += [(m, to_torch(decode_dense_case(
            m, modes=DECODE_DENSE_GQA_MODES), cuda))
            for m in ("gqa_6", "rows_past_16")]
    op = dense_dec_ops.decode_attention_kv
    for name, (q, k, v, valid) in cases:
        q, k, v = (t.to(dtype) for t in (q, k, v))
        got = op(q, k, v, valid)
        want = _dense_plain(q, k, v, valid)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=BF16_TOL, atol=BF16_TOL)
        else:
            assert (got - want).abs().max().item() <= GPU_TOL, name
        for b in range(q.shape[0]):
            alone = op(q[b:b + 1], k[b:b + 1], v[b:b + 1], valid[b:b + 1])
            torch.cuda.synchronize()
            assert torch.equal(alone[0], got[b]), (name, b)
        B, S, K, D = k.shape
        tail = lambda t: torch.cat([t, torch.randn(
            (B, 256, K, D), generator=g, device=cuda).to(dtype)], 1)
        longer = torch.cat([valid, torch.zeros(
            (B, 256), dtype=torch.int8, device=cuda)], 1)
        wide = op(q, tail(k), tail(v), longer)
        torch.cuda.synchronize()
        assert torch.equal(wide, got), name


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["windowed_sink", "gemma3"])
def test_cuda_decode_attention_bf16_reads_no_invalid_row(mode, cuda):
    """NaN in every K and V row of an invalid key, at bf16: the output is
    finite and bit-identical to the one with finite rows (the bf16 design
    zero-fills an invalid key's shared row and reads nothing of it). On
    windowed_sink (the first 512 keys invalid) and at gemma3-4b's
    local-layer decode (the 1024-key window at position 2064)."""
    if mode == "gemma3":
        g = torch.Generator(device=cuda).manual_seed(0)
        B, S, K, G, D = 8, 2080, 4, 2, 256
        q = torch.randn((B, K * G, D), generator=g, device=cuda) * D ** -0.5
        k = torch.randn((B, S, K, D), generator=g, device=cuda)
        v = torch.randn((B, S, K, D), generator=g, device=cuda)
        pos = torch.arange(S, device=cuda)
        valid = ((pos <= 2064) & (2064 - pos < 1024)).to(torch.int8)[None] \
            .expand(B, S).contiguous()
    else:
        q, k, v, valid = to_torch(decode_dense_case(mode), cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    op = dense_dec_ops.decode_attention_kv
    base = op(q, k, v, valid)
    bad = (valid == 0)[..., None, None].expand_as(k)
    nan = torch.tensor(float("nan"), dtype=torch.bfloat16, device=cuda)
    got = op(q, torch.where(bad, nan, k), torch.where(bad, nan, v), valid)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all(), mode
    assert torch.equal(got, base), mode
    torch.testing.assert_close(base.float(),
                               _dense_plain(q, k, v, valid).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", sorted(DECODE_DENSE_GQA_MODES))
def test_cuda_decode_attention_gqa_tiles_match_plain_version(mode, dtype,
                                                             cuda):
    """G = 6, 12 and 18 (one or two 16-row tiles of the bf16 design; one
    to three 8-row blocks of the fp32 design) against the plain version,
    read in place and through a slab whose rows lie D + 1 values apart
    (the bf16 design's 2-byte copies)."""
    q, k, v, valid = (t.to(dtype) if t.is_floating_point() else t
                      for t in to_torch(decode_dense_case(
                          mode, modes=DECODE_DENSE_GQA_MODES), cuda))
    want = _dense_plain(q, k, v, valid)
    op = dense_dec_ops.decode_attention_kv
    D = k.shape[-1]
    wide = [torch.nn.functional.pad(t, (0, 1))[..., :D] for t in (k, v)]
    for got in (op(q, k, v, valid), op(q, *wide, valid)):
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=BF16_TOL, atol=BF16_TOL)
        else:
            assert (got - want).abs().max().item() <= GPU_TOL, mode


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
@pytest.mark.parametrize("offset", [0, 4])
def test_cuda_decode_attention_bf16_zeroes_counts_in_any_workspace(offset,
                                                                   cuda):
    """The bf16 design's launch zeroes its counts of finished splits itself
    and merges through a workspace at any 4-byte alignment: over a
    workspace whose every byte is 0xff, 16-byte aligned (the merge's
    16-byte loads of the partials) or 4 bytes past it (4-byte loads), G = 6
    over three splits matches the plain version at bf16."""
    q, k, v = (t.to(torch.bfloat16) for t in to_torch(decode_dense_case(
        "gqa_6", modes=DECODE_DENSE_GQA_MODES), cuda)[:3])
    valid = to_torch(decode_dense_case("gqa_6",
                                       modes=DECODE_DENSE_GQA_MODES), cuda)[3]
    B, S, K, D = k.shape
    G = q.shape[1] // K
    name = dense_dec_ops.NAME
    n = common.query(name, "decode_attention_workspace_bytes", B, S, K, G, D)
    assert n > 0, "the case must span more than one split"
    ws = torch.full((n + 16,), 0xFF, dtype=torch.uint8, device=cuda)
    out = torch.full_like(q, float("nan"))
    common.launch(name, "decode_attention_bf16", q, k, v, valid, out,
                  ws[offset:], B, S, K, G, D, *k.stride()[:3])
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               _dense_plain(q, k, v, valid).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def ssd_typed(ts, dtype, x_b_c=(0, 3, 4)):
    """The SSD inputs with x, B and C (the positions ``x_b_c`` of ``ts``)
    cast to ``dtype``; dt and dA stay fp32, as the model passes them."""
    return [t.to(dtype) if i in x_b_c else t for i, t in enumerate(ts)]


SSD_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SSD_DTYPES)
@pytest.mark.parametrize("mode", sorted(SSD_MODES))
def test_cuda_ssd_chunk_scan_matches_plain_version(mode, dtype, cuda):
    """The SSD chunk kernel through both entries (the TPU kernel's layout,
    and the model's layout read and written through strides) against the
    plain versions on the card, with x, B and C at fp32 and at bf16 (its
    bf16 instance, fp32 outputs, held at the fp32 instance's tolerance:
    its arithmetic is fp32 on exact inputs). A whole row of dt = 0 gives a
    state of exactly 0, and steep dA gives finite outputs."""
    x, dt, da, B, C = ssd_typed(to_torch(ssd_case(mode), cuda), dtype)
    key = str(dtype).removeprefix("torch.")
    n0 = ssd_ops.ssd_chunk_scan.launches
    d0 = ssd_ops.ssd_chunk_scan.launches_by_dtype.get(key, 0)
    y, st = ssd_ops.ssd_chunk_scan(x, dt, da, B, C)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == n0 + 1
    assert ssd_ops.ssd_chunk_scan.launches_by_dtype[key] == d0 + 1
    assert y.dtype == st.dtype == torch.float32
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
@pytest.mark.parametrize("dtype", SSD_DTYPES)
@pytest.mark.parametrize("l", [1, 2, 8, 16, 17, 256])
def test_cuda_ssd_bc_alone_is_bitwise_packed(l, dtype, cuda):
    """Each bc of a packed launch (8 chunks, both entries) gives the same
    bits as the same chunk launched alone: no sum depends on BC (x, B and
    C at fp32 and at bf16)."""
    case = ssd_bucket_case(l, l, seed=l)
    x, dt, da, B, C = model = ssd_typed(to_torch(case, cuda), dtype)
    packed = ssd_ops.ssd_chunk(*model)
    # the same chunks in the TPU kernel's layout
    x_, dt_, da_ = (a[:, 0].swapaxes(1, 2) for a in case[:3])
    flat = ssd_typed(to_torch([a.copy() for a in (
        x_, dt_[..., None], da_[..., None], case[3][:, 0], case[4][:, 0])],
        cuda), dtype)
    packed_tpu = ssd_ops.ssd_chunk_scan(*flat)
    for k in range(x.shape[0]):
        alone = ssd_ops.ssd_chunk(*(t[k:k + 1] for t in model))
        alone_tpu = ssd_ops.ssd_chunk_scan(*(t[k:k + 1] for t in flat))
        for got, want in zip(alone + alone_tpu, packed + packed_tpu):
            assert torch.equal(got[0], want[k]), (l, k)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SSD_DTYPES)
@pytest.mark.parametrize("n", SSD_BUCKET_LENS)
def test_cuda_ssd_buckets_are_bitwise_equal(n, dtype, cuda):
    """A chunk of n real positions padded with dt = 0 (and other x, B, C
    past n) to each l bucket of the pool gives the same bits in its n rows
    of y and in its state: the padding adds exact zeros, and every sum
    runs over the same key steps (8 keys at fp32, 16 at bf16) at the same
    absolute positions (x, B and C at fp32 and at bf16)."""
    outs = []
    for l in ssd_buckets(n):
        y, st = ssd_ops.ssd_chunk(*ssd_typed(
            to_torch(ssd_bucket_case(n, l), cuda), dtype))
        outs.append((l, y[:, :, :n], st))
    torch.cuda.synchronize()
    for l, y, st in outs[1:]:
        assert torch.equal(y, outs[0][1]), (n, l)
        assert torch.equal(st, outs[0][2]), (n, l)


# --------------------------------------------------- jamba-v0.1-52b shapes
@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(JAMBA_MODES))
def test_cuda_kernels_at_jamba_shapes(mode, cuda):
    """Each kernel at jamba-v0.1-52b's shapes through the wrapper the
    model calls, against its plain version on the same card inputs; the
    wrapper launches its kernel once and no other kernel launches."""
    n0 = {op: op.launches for op in (
        dec_ops.paged_decode_attention_gqa,
        pre_ops.paged_prefill_attention_gqa, flash_ops.flash_attention,
        dense_dec_ops.decode_attention_kv, ssd_ops.ssd_chunk_scan)}
    if mode in ("paged_decode", "paged_prefill"):
        case, op, ref = (
            (decode_case, dec_ops.paged_decode_attention_gqa,
             dec_ops.paged_decode_attention_ref) if mode == "paged_decode"
            else (prefill_case, pre_ops.paged_prefill_attention_gqa,
                  pre_ops.paged_prefill_attention_ref))
        args, kw = case(mode, modes=JAMBA_MODES)
        dev = to_torch(args, cuda)
        got, want = op(*dev, **kw), ref(*dev, **kw)
        err = (got - want).abs().max().item()
    elif mode == "flash":
        args, kw = flash_case(mode, modes=JAMBA_MODES)
        q, k, v = to_torch(args, cuda)
        op, (B, S, H, D) = flash_ops.flash_attention, q.shape
        got = op(q, k, v, **kw)
        bhsd = lambda t: t.repeat_interleave(H // t.shape[2], 2) \
            .movedim(2, 1).reshape(B * H, S, D).contiguous()
        want = flash_ops.attention_ref(bhsd(q), bhsd(k), bhsd(v), **kw)
        err = (got.movedim(2, 1).reshape(B * H, S, D) - want).abs().max() \
            .item()
    elif mode == "dense_decode":
        q, k, v, valid = to_torch(decode_dense_case(mode, modes=JAMBA_MODES),
                                  cuda)
        op = dense_dec_ops.decode_attention_kv
        got = op(q, k, v, valid)
        err = (got - _dense_plain(q, k, v, valid)).abs().max().item()
    else:
        x, dt, da, B, C = to_torch(ssd_case(mode, modes=JAMBA_MODES), cuda)
        op = ssd_ops.ssd_chunk_scan
        got = op(x, dt, da, B, C)
        want = ssd_ops.ssd_chunk_ref(x, dt, da, B, C)
        # SSD_TOL is relative to the output's scale (ssd_err)
        err = max(ssd_err(g, w) for g, w in zip(got, want)) \
            * GPU_TOL / SSD_TOL
        if JAMBA_MODES[mode][-1] == "pad":
            assert not got[1][-1].any(), "a dt = 0 row must add exactly 0"
    torch.cuda.synchronize()
    assert {o.__name__: o.launches - n for o, n in n0.items()} == \
        {o.__name__: int(o is op) for o in n0}
    assert err <= GPU_TOL, (mode, err)


@pytest.mark.gpu
@pytest.mark.parametrize("drops", [False, True], ids=["no_drop", "drops"])
def test_cuda_moe_forward_matches_cpu(drops, cuda):
    """The MoE layer on the card against the CPU, same weights and inputs:
    the same chosen experts and drop mask, the output within GPU_TOL of
    its scale and the aux loss within 1e-5 relative. The drop case
    repeats one PAD vector over a 150-position tail, past the capacity
    of 128."""
    import dataclasses
    from repro_torch.configs.phi35_moe_42b import CONFIG as PHI
    from repro_torch.models import moe
    from repro_torch.models.common import init_params_
    cfg = dataclasses.replace(PHI, d_model=512, d_ff=768,
                              capacity_factor=0.1 if drops else 1.25)
    cpu = init_params_(moe.MoE(cfg, "cpu"), torch.Generator().manual_seed(0))
    card = moe.MoE(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    x = np.random.default_rng(1).standard_normal((3, 160, cfg.d_model)) \
        .astype(np.float32)
    if drops:
        x[0, 10:] = x[0, 10]
    outs = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        xt = torch.tensor(x, device=dev)
        with torch.no_grad():
            outs.append((moe.route(model, xt, cfg)[1:3],
                         moe.moe_forward(model, xt, cfg)))
    (cpu_route, (cpu_y, cpu_aux)), (card_route, (card_y, card_aux)) = outs
    for a, b in zip(cpu_route, card_route):
        assert torch.equal(a, b.cpu())
    assert bool((~cpu_route[1]).any()) == drops
    # sums over d_model and d_ff terms: GPU_TOL relative to the output's
    # scale, as for the SSD scan (ssd_err)
    assert ssd_err(card_y.cpu(), cpu_y) <= GPU_TOL
    assert abs(card_aux.item() - cpu_aux.item()) <= 1e-5 * cpu_aux.item()


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

        def counted(*args, step=eng.step, name=name, **kw):
            d0 = dec_ops.paged_decode_attention_gqa.launches
            p0 = pre_ops.paged_prefill_attention_gqa.launches
            out = step(*args, **kw)
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
@pytest.mark.parametrize("name", ["burst", "escalation-storm",
                                  "spec-stall", "prefix-thrash"])
def test_cuda_fault_scenarios(name, cuda):
    """The port's burst, escalation-storm, spec-stall and prefix-thrash
    chaos scenarios on the card, through both paged kernels: every
    invariant holds (refcounts and the draft mirror included), and
    preempted, escalated, speculative and prefix-sharing streams emit the
    tokens of uncontended runs (the scenarios' own checks)."""
    from repro_torch.serving import faults
    d0 = dec_ops.paged_decode_attention_gqa.launches
    p0 = pre_ops.paged_prefill_attention_gqa.launches
    h = faults.SCENARIOS[name](verbose=False, device="cuda")
    assert h.check_invariants() == []
    assert dec_ops.paged_decode_attention_gqa.launches > d0
    assert pre_ops.paged_prefill_attention_gqa.launches > p0


# ------------------------------------- whisper-large-v3, internvl2-26b
@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(ENCDEC_VLM_MODES))
def test_cuda_kernels_at_encdec_and_vlm_shapes(mode, cuda):
    """The flash and dense decode kernels at whisper-large-v3's and
    internvl2-26b's shapes through the wrapper the model calls, against
    their plain versions on the same card inputs; the wrapper launches
    its kernel once and no other kernel launches."""
    ops = (flash_ops.flash_attention, dense_dec_ops.decode_attention_kv)
    n0 = {op: op.launches for op in ops}
    if "flash" in mode:
        args, kw = flash_case(mode, modes=ENCDEC_VLM_MODES)
        q, k, v = to_torch(args, cuda)
        op, (B, S, H, D) = flash_ops.flash_attention, q.shape
        got = op(q, k, v, **kw)
        bhsd = lambda t: t.repeat_interleave(H // t.shape[2], 2) \
            .movedim(2, 1).reshape(B * H, S, D).contiguous()
        want = flash_ops.attention_ref(bhsd(q), bhsd(k), bhsd(v), **kw)
        err = (got.movedim(2, 1).reshape(B * H, S, D) - want).abs().max() \
            .item()
    else:
        q, k, v, valid = to_torch(
            decode_dense_case(mode, modes=ENCDEC_VLM_MODES), cuda)
        op = dense_dec_ops.decode_attention_kv
        got = op(q, k, v, valid)
        err = (got - _dense_plain(q, k, v, valid)).abs().max().item()
    torch.cuda.synchronize()
    assert {o.__name__: o.launches - n for o, n in n0.items()} == \
        {o.__name__: int(o is op) for o in ops}
    assert err <= GPU_TOL, (mode, err)


# ------------------------------------------------------ the dry run's steps
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["prefill", "decode", "ssm_prefill"])
def test_cuda_bf16_steps_match_plain_version(kind, cuda):
    """A bf16 config (the dry run's dtype) through ``launch.steps``'
    prefill and decode steps on the card: each launches its bf16 kernel
    (K4 a layer in prefill, K5 a layer in decode, K3 a layer in an SSM
    stack's prefill, over two 8-position chunks) and its bf16 logits lie
    within 2 BF16_TOL of the same step's on the CPU, which runs the plain
    versions at bf16 (two layers of bf16 roundings in another order)."""
    from repro_torch.launch import steps
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model import build_model
    if kind == "ssm_prefill":
        cfg = ArchConfig("bf16-ssm", "ssm", 2, 64, 0, 0, 0, 256,
                         ssm_state=16, ssm_headdim=16, ssm_chunk=8,
                         vocab_pad_multiple=64, dtype="bfloat16")
    else:
        cfg = ArchConfig("bf16", "dense", 2, 64, 4, 2, 128, 256,
                         head_dim=16, vocab_pad_multiple=64,
                         dtype="bfloat16")
    bundle = build_model(cfg)
    cpu = bundle.init(torch.Generator().manual_seed(0), "cpu")
    model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  "cpu").to(cuda)
    S = 16 if kind == "ssm_prefill" else 8
    tokens = torch.randint(3, 256, (2, S),
                           generator=torch.Generator().manual_seed(1))
    op = {"prefill": flash_ops.flash_attention,
          "decode": dense_dec_ops.decode_attention_kv,
          "ssm_prefill": ssd_ops.ssd_chunk_scan}[kind]
    n0 = op.launches_by_dtype.get("bfloat16", 0)
    if kind != "decode":
        step = steps.build_prefill_step(bundle, S)
        got = step(model, {"tokens": tokens.to(cuda)})[0]
        want = step(cpu, {"tokens": tokens})[0]
    else:
        step = steps.build_decode_step(bundle, False)
        outs = []
        for m, dev in ((model, cuda), (cpu, "cpu")):
            cache = bundle.init_cache(2, 8, device=dev)
            g = torch.Generator().manual_seed(2)
            for key in ("k", "v"):
                cache[key].copy_(torch.randn(cache[key].shape, generator=g))
            cache["pos"] = 3
            outs.append(step(m, cache, tokens[:, :1].to(dev))[0])
        got, want = outs
    torch.cuda.synchronize()
    assert op.launches_by_dtype["bfloat16"] - n0 == cfg.n_layers
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=2 * BF16_TOL, atol=2 * BF16_TOL)


# The attention core on a launcher's mesh, on the card: one process is
# rank 0 of a fake process group of 8 (collectives return at once), a
# (2, 4) ("data", "model") mesh over CUDA. Replicated inputs cut to this
# rank's shard move no data, so rank 0's output is exact.
MESH_ATTEND = r"""
import json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.mesh import fake_process_group
from repro_torch.models.attention import _attend, _chunked_attention
from repro_torch.sharding.context import activation_sharding

fake_process_group(8)
mesh = DeviceMesh("cuda", torch.arange(8).reshape(2, 4),
                  mesh_dim_names=("data", "model"))
case = sys.argv[1]
# "heads": 8 query heads on 4 ranks, 2 KV heads (rank 0 reads a slice of
# KV head 0: a strided view); "query_shard": 6 heads do not divide 4, so
# sequence parallelism shards the queries
H, K = (8, 2) if case == "heads" else (6, 2)
B, S, D = 2, 64, 32
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(B, S, n, D, generator=g).cuda() * (D ** -0.25)
           for n in (H, K, K))
rep = lambda t: DTensor.from_local(t, mesh, (Replicate(), Replicate()),
                                   run_check=False)
dtype = getattr(torch, sys.argv[2])
q, k, v = (t.to(dtype) for t in (q, k, v))
kernel = lambda q, k, v: flash_attention(q, k, v, causal=True, window=0)
pos = torch.arange(S, device="cuda")
n0 = flash_attention.launches
with activation_sharding(mesh, "data", seq_shard=(case != "heads")):
    out = _attend(kernel, rep(q), rep(k), rep(v), pos, causal=True,
                  window=0, chunk=16)
# rank 0's shard: its batch row and, with the heads, query heads 0-1 over
# KV head 0; with a query shard, all 6 heads at positions 0-15 (gathered
# back to the whole sequence; the fake group moves no data, so only rank
# 0's own rows are its)
if case == "heads":
    mine, rows = (q[:1, :, :2], k[:1, :, :1], v[:1, :, :1], pos), S
else:
    mine, rows = (q[:1], k[:1], v[:1], pos), S // 4
local = out.to_local()[:, :rows]
want = _chunked_attention(*(t.cpu() for t in mine), causal=True, window=0,
                          chunk=S)
print(json.dumps({"shape": list(out.to_local().shape),
                  "launches": flash_attention.launches - n0,
                  "dtype": str(local.dtype),
                  "err": (local.float().cpu()
                          - want[:, :rows].float()).abs().max().item()}))
"""


def _mesh_attend(case, dtype="float32"):
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run([sys.executable, "-c", MESH_ATTEND, case, dtype],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", GPU_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_cuda_mesh_attend_runs_the_flash_kernel_on_head_shards(dtype, tol,
                                                               cuda):
    """On a CUDA mesh a rank's shard of whole sequences (its batch rows,
    its query heads and, as a strided slice, the one KV head they read)
    goes through the flash kernel, once, and equals the plain version."""
    got = _mesh_attend("heads", dtype)
    assert got["shape"] == [1, 64, 2, 32] and got["dtype"] == f"torch.{dtype}"
    assert got["launches"] == 1
    assert got["err"] <= tol, got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", GPU_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_cuda_mesh_attend_query_shard_matches_plain_version(dtype, tol,
                                                            cuda):
    """A query shard (sequence parallelism: 6 heads do not divide "model"'s
    4) runs the flash kernel once over the whole sequence, its rows in
    place and zeros elsewhere, and keeps its rows: they equal the plain
    version's rows 0-15 of the rank's batch row."""
    got = _mesh_attend("query_shard", dtype)
    assert got["shape"] == [1, 64, 6, 32] and got["dtype"] == f"torch.{dtype}"
    assert got["launches"] == 1
    assert got["err"] <= tol, got

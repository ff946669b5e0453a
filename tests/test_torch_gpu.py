"""The port on the card (marker ``gpu``; skips where there is no CUDA
device). Imports no JAX: run it on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Each CUDA kernel, launched through its wrapper, against its plain version
on the same device inputs, over every launch mode below. The launch modes
and their inputs, made with numpy from a seed, are shared with the CPU
parity tests (test_torch_paged_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_decode_attention import ops as dec_ops
from repro_torch.kernels.paged_prefill_attention import ops as pre_ops

GPU_TOL = 1e-4    # fp32 kernel vs plain version: another summation order

# name -> (B, K, G, D, ps, MP, pages_bound, pages_start, window)
DECODE_MODES = {
    "full_walk": (3, 2, 1, 32, 8, 4, None, 0, 0),
    "live_bound": (3, 2, 2, 32, 8, 6, 3, 0, 0),
    "gqa": (2, 2, 8, 16, 8, 3, None, 0, 0),
    "head_dim_24": (3, 2, 1, 24, 16, 3, None, 0, 0),
    "window_late_start": (3, 2, 2, 16, 8, 6, 5, 1, 8),
}
# name -> (B, K, C, G, D, ps, MP, pages_bound, pages_start, window)
PREFILL_MODES = {
    "full_walk": (3, 2, 4, 1, 32, 8, 4, None, 0, 0),
    "live_bound": (3, 2, 4, 2, 32, 8, 6, 3, 0, 0),
    "gqa": (2, 2, 4, 8, 16, 8, 3, None, 0, 0),
    "head_dim_24": (3, 2, 5, 1, 24, 16, 3, None, 0, 0),
    "window_late_start": (3, 2, 4, 2, 16, 8, 6, 5, 1, 8),
}


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
@pytest.mark.parametrize("mode", sorted(DECODE_MODES))
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

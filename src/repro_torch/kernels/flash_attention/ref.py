"""Plain PyTorch version of the flash-attention kernel.

Mirrors ``repro/kernels/flash_attention/ref.py``: the full (S, S) score
matrix, masked and softmaxed. The CPU path of ``ops.flash_attention`` and
the yardstick the CUDA kernel is held against on the card.
At bf16 it rounds where the oracle does: the scores to bf16 before an
fp32 softmax, the weights to bf16 before the product with V, the output
in V's dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k, v: (BH, S, D), q pre-scaled. Returns (BH, S, D)."""
    S = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k).float()
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype), v)

"""Plain PyTorch version of the dense-cache GQA decode-attention kernel.

Mirrors ``repro/kernels/decode_attention/ref.py``. The CPU path of
``ops.decode_attention_kv`` and the yardstick the CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, valid):
    """q: (BK, G, D) pre-scaled; k, v: (BK, S, D); valid: (BK, S) bool/int.

    Returns (BK, G, D)."""
    s = torch.einsum("bgd,bsd->bgs", q, k).float()
    s = torch.where(valid[:, None, :] > 0, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bgs,bsd->bgd", w.to(v.dtype), v)

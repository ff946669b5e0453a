"""Plain PyTorch version of the paged GQA decode-attention kernel.

Mirrors ``repro/kernels/paged_decode_attention/ref.py``: gathers each
request's pages through its page-table row into a dense key space and runs
masked attention. The CPU path of ``ops.paged_decode_attention_gqa`` and
the yardstick the CUDA kernel is held against on the card.
At bf16 it rounds where the oracle does: the scores to bf16 before an
fp32 softmax, the weights to bf16 before the product with V, the output
in V's dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                               pages_bound=None, pages_start=0, window=0):
    """q: (B, K, G, D) pre-scaled; k_pages/v_pages: (P, ps, K, D);
    page_table: (B, MP) int32; seq_lens: (B,) int32. ``pages_bound``: live
    bound on the page walk (every seq_len must fit in that many pages);
    None gathers the full table width. ``window``: sliding-window size
    (0 = global) — keys older than the query's trailing ``window``
    positions are masked by global position. ``pages_start``: first walked
    page (window layers only; every first in-window key must be
    ``>= pages_start * ps``). Returns (B, K, G, D)."""
    B, K, G, D = q.shape
    ps = k_pages.shape[1]
    assert pages_start == 0 or window > 0, (pages_start, window)
    end = page_table.shape[1] if pages_bound is None else pages_bound
    page_table = page_table[:, pages_start:end].long()
    MP = page_table.shape[1]
    # (B, MP, ps, K, D) -> (B, K, MP*ps, D)
    k = k_pages[page_table].movedim(3, 1).reshape(B, K, MP * ps, D)
    v = v_pages[page_table].movedim(3, 1).reshape(B, K, MP * ps, D)
    s = torch.einsum("bkgd,bksd->bkgs", q, k).float()
    kpos = pages_start * ps + torch.arange(MP * ps, device=q.device)
    lens = seq_lens.long()[:, None]
    valid = kpos[None] < lens                                   # (B, MP*ps)
    if window > 0:
        valid &= kpos[None] >= lens - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    # a fully masked row (an idle slot, or a window entirely before the
    # walk start) softmaxes to uniform garbage; zero it like the kernel does
    w = torch.where(valid, w, 0.0)
    return torch.einsum("bkgs,bksd->bkgd", w.to(v.dtype), v)

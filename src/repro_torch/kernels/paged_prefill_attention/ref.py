"""Plain PyTorch version of the paged GQA prefill-attention kernel.

Mirrors ``repro/kernels/paged_prefill_attention/ref.py``: gathers each
request's pages through its page-table row into a dense key space and runs
causally masked attention for the chunk's query rows. Like the kernel it
assumes the chunk's K/V are already resident in the pool. The CPU path of
``ops.paged_prefill_attention_gqa`` and the yardstick the CUDA kernel is
held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_prefill_attention_ref(q, k_pages, v_pages, page_table, start,
                                total, pages_bound=None, pages_start=0,
                                window=0):
    """q: (B, K, C, G, D) pre-scaled; k_pages/v_pages: (P, ps, K, D);
    page_table: (B, MP) int32; start/total: (B,) int32. ``pages_bound``:
    live bound on the page walk (every ``total`` must fit in that many
    pages); None gathers the full table width. ``window``: sliding-window
    size (0 = global), masked by global position. ``pages_start``: first
    walked page (window layers only; every request's earliest in-window key
    must be ``>= pages_start * ps``). Returns (B, K, C, G, D)."""
    B, K, C, G, D = q.shape
    ps = k_pages.shape[1]
    assert pages_start == 0 or window > 0, (pages_start, window)
    end = page_table.shape[1] if pages_bound is None else pages_bound
    page_table = page_table[:, pages_start:end].long()
    MP = page_table.shape[1]
    S = MP * ps
    # (B, MP, ps, K, D) -> (B, K, MP*ps, D)
    k = k_pages[page_table].movedim(3, 1).reshape(B, K, S, D)
    v = v_pages[page_table].movedim(3, 1).reshape(B, K, S, D)
    s = torch.einsum("bkcgd,bksd->bkcgs", q, k).float()
    kpos = pages_start * ps + torch.arange(S, device=q.device)
    qpos = start.long()[:, None] + torch.arange(C, device=q.device)  # (B, C)
    valid = (kpos[None, None, :] <= qpos[:, :, None]) \
        & (kpos[None, None, :] < total.long()[:, None, None])       # (B, C, S)
    if window > 0:
        valid &= (qpos[:, :, None] - kpos[None, None, :]) < window
    valid = valid[:, None, :, None, :]
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    # fully masked query rows softmax to uniform garbage; zero them the way
    # the kernel's re-mask does
    w = torch.where(valid, w, 0.0)
    return torch.einsum("bkcgs,bksd->bkcgd", w.to(v.dtype), v)

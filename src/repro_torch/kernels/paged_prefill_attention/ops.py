"""Wrapper of the paged GQA prefill-attention kernel (chunked prefill).

The tensor's device decides the path: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the hand-written kernel
``csrc/paged_prefill_attention.cu`` or raise. There is no fallback between
the two. ``paged_prefill_attention_gqa.launches`` counts wrapper calls
that launched the kernel.
"""
from __future__ import annotations

import torch

from ..common import MAX_SMEM_BYTES, check_inputs, launch, query
from .ref import paged_prefill_attention_ref

MAX_HEAD_DIM = 256
NAME = "paged_prefill_attention"


def paged_prefill_attention_gqa(q, k_pages, v_pages, page_table, start,
                                total, *, pages_bound=None, pages_start=0,
                                window=0):
    """q: (B, K, C, G, D) pre-scaled; k_pages/v_pages: (P, ps, K, D);
    page_table: (B, MP) int32; start/total: (B,) int32 (tokens resident
    before the chunk / after it). ``pages_bound``: the caller guarantees
    every ``total`` fits in that many pages (None walks the full table
    width); ``window``: sliding-window size (0 = global); ``pages_start``:
    first walked page (window layers only). Returns (B, K, C, G, D) in q's
    dtype, accumulated in fp32."""
    B, K, C, G, D = q.shape
    _, ps, Kk, Dk = k_pages.shape
    MP = page_table.shape[1]
    end = MP if pages_bound is None else pages_bound
    if (Kk, Dk) != (K, D):
        raise ValueError(f"pool {tuple(k_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if window < 0 or pages_start < 0 or (pages_start and not window):
        raise ValueError("pages_start > 0 is only sound under a sliding "
                         f"window (window={window}, pages_start={pages_start})")
    if not 1 <= end - pages_start or end > MP:
        raise ValueError(f"page walk [{pages_start}, {end}) outside a table "
                         f"of width {MP}")
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, page_table,
                                           start, total, pages_bound,
                                           pages_start, window)
    check_inputs(NAME,
                 {"q": q, "k_pages": k_pages, "v_pages": v_pages},
                 {"page_table": page_table, "start": start, "total": total})
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM}: not supported")
    # the kernel's geometry lives in its source, which says what a launch
    # needs
    if query(NAME, "paged_prefill_smem_bytes", C, G, D) > MAX_SMEM_BYTES:
        raise ValueError(f"{C * G} rows at head_dim {D} need more shared "
                         "memory than a block has")
    out = torch.empty_like(q)
    if B:
        # each split's partial (m, l, accumulator) and the counts of
        # finished splits, where a walk spans more than one split: carved
        # and zeroed by the launch, on its stream
        n = query(NAME, "paged_prefill_workspace_bytes", B, K, C, G, D, ps,
                  pages_start, end)
        ws = torch.empty(n, dtype=torch.uint8, device=q.device) if n else out
        launch(NAME, "paged_prefill_attention_f32", q, k_pages, v_pages,
               page_table, start, total, out, ws, B, K, C, G, D, ps, MP,
               pages_start, end, window)
        paged_prefill_attention_gqa.launches += 1
    return out


paged_prefill_attention_gqa.launches = 0

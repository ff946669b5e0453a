"""Wrapper of the paged GQA decode-attention kernel.

The tensor's device decides the path: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the hand-written kernel
``csrc/paged_decode_attention.cu`` or raise. There is no fallback between
the two. ``paged_decode_attention_gqa.launches`` counts wrapper calls
that launched the kernel.
"""
from __future__ import annotations

import torch

from ..common import check_inputs, launch, query
from .ref import paged_decode_attention_ref

MAX_HEAD_DIM = 256
NAME = "paged_decode_attention"


def paged_decode_attention_gqa(q, k_pages, v_pages, page_table, seq_lens, *,
                               pages_bound=None, pages_start=0, window=0):
    """q: (B, K, G, D) pre-scaled; k_pages/v_pages: (P, ps, K, D);
    page_table: (B, MP) int32; seq_lens: (B,) int32. ``pages_bound``: the
    caller guarantees every seq_len fits in that many pages (None walks the
    full table width); ``window``: sliding-window size (0 = global);
    ``pages_start``: first walked page (window layers only). Returns
    (B, K, G, D) in q's dtype, accumulated in fp32."""
    B, K, G, D = q.shape
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
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          seq_lens, pages_bound, pages_start,
                                          window)
    check_inputs(NAME, {"q": q, "k_pages": k_pages, "v_pages": v_pages},
                 {"page_table": page_table, "seq_lens": seq_lens})
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM}: not supported")
    out = torch.empty_like(q)
    if B:
        # each split's partial (m, l, accumulator) and the counts of
        # finished splits, where a walk spans more than one split: the
        # kernel's source says how much (its geometry lives there), and the
        # launch carves it and zeroes the counts, on its stream
        n = query(NAME, "paged_decode_workspace_bytes", B, K, G, D, ps,
                  pages_start, end)
        ws = torch.empty(n, dtype=torch.uint8, device=q.device) if n else out
        launch(NAME, "paged_decode_attention_f32", q, k_pages, v_pages,
               page_table, seq_lens, out, ws, B, K, G, D, ps, MP,
               pages_start, end, window)
        paged_decode_attention_gqa.launches += 1
    return out


paged_decode_attention_gqa.launches = 0

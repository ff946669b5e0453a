"""Grouped-query attention over a paged KV cache (the paged part of
``repro.models.attention``).

Two entry points serve continuous batching: ``paged_decode_attention`` (one
new token per slot) and ``paged_prefill_attention`` (a chunk of prompt
tokens per slot). Each writes the new K/V into the layer's page pool in
place and then attends through the paged kernel wrappers, which launch the
CUDA kernels for CUDA tensors and take the plain versions for CPU tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.paged_decode_attention.ops import \
    paged_decode_attention_gqa
from repro_torch.kernels.paged_prefill_attention.ops import \
    paged_prefill_attention_gqa
from .common import apply_rope, dtype_of, empty_param


class Attention(nn.Module):
    """Weights in the reference's layouts: wq (D, H, Dh), wk/wv (D, K, Dh),
    wo (H*Dh, D), and with ``qkv_bias`` bq (H, Dh), bk/bv (K, Dh)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, H, K, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim)
        dt = dtype_of(cfg)
        self.wq = empty_param((D, H, Dh), dt, device)
        self.wk = empty_param((D, K, Dh), dt, device)
        self.wv = empty_param((D, K, Dh), dt, device)
        self.wo = empty_param((H * Dh, D), dt, device)
        if cfg.qkv_bias:
            self.bq = empty_param((H, Dh), dt, device)
            self.bk = empty_param((K, Dh), dt, device)
            self.bv = empty_param((K, Dh), dt, device)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    D, H, Dh = w.shape
    return (x @ w.reshape(D, H * Dh)).reshape(*x.shape[:-1], H, Dh)


def _project_qkv(attn: Attention, x, cfg, positions):
    q, k, v = _proj(x, attn.wq), _proj(x, attn.wk), _proj(x, attn.wv)
    if cfg.qkv_bias:
        q = q + attn.bq
        k = k + attn.bk
        v = v + attn.bv
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(attn: Attention, out, B, S, H, Dh):
    return out.reshape(B, S, H * Dh) @ attn.wo


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, n_layers: int,
                        device="cuda"):
    """Shared page pool: (n_layers, num_pages, page_size, K, Dh) per tensor.

    Page 0 is reserved as the pool's scratch page (writes for inactive slots
    and masked reads land there); allocators hand out pages >= 1.
    """
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, num_pages, page_size, K, Dh)
    dt = dtype_of(cfg)
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


def paged_decode_attention(attn: Attention, x_t, k_pages, v_pages,
                           page_table, seq_lens, active, cfg,
                           pages_bound=None):
    """One decode step against a paged KV cache (continuous batching).

    x_t: (B, 1, D) — one new token per serving slot. k_pages/v_pages:
    (P, ps, K, Dh), this layer's pool; page_table: (B, MP) int32;
    seq_lens: (B,) int32 tokens already in each slot's cache (the new token
    lands at index seq_lens); active: (B,) bool — inactive slots write to
    the reserved scratch page 0 and their output is garbage the engine
    masks. ``pages_bound``: live bound on the kernel's page walk (every
    active slot's context must fit; None = the full table width). Global
    attention: the kernel's window and first walked page stay 0 until the
    sliding-window slice.

    The new K/V are written into ``k_pages``/``v_pages`` IN PLACE
    (``index_put_``): the reference's ``.at[].set`` on donated buffers
    becomes a true in-place write. Returns out (B, 1, D).
    """
    B = x_t.shape[0]
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ps = k_pages.shape[1]
    MP = page_table.shape[1]
    cap = MP * ps
    pos = torch.clamp(seq_lens, max=cap - 1)                 # write position
    q, k_t, v_t = _project_qkv(attn, x_t, cfg, pos[:, None])
    slot_pos = pos.long()
    page = page_table[torch.arange(B, device=pos.device), slot_pos // ps]
    page = torch.where(active, page, 0).long()               # scratch for idle
    k_pages[page, slot_pos % ps] = k_t[:, 0]
    v_pages[page, slot_pos % ps] = v_t[:, 0]
    lens = torch.clamp(seq_lens + 1, max=cap)                # incl. new token
    qg = (q[:, 0] * Dh ** -0.5).reshape(B, K, H // K, Dh)
    out = paged_decode_attention_gqa(qg, k_pages, v_pages, page_table, lens,
                                     pages_bound=pages_bound)
    return _out_proj(attn, out.reshape(B, 1, H, Dh), B, 1, H, Dh)


def paged_prefill_attention(attn: Attention, x, k_pages, v_pages,
                            page_table, start, n_new, cfg, pages_bound=None):
    """One chunked-prefill step against a paged KV cache.

    x: (B, C, D) — a fixed-width chunk of prompt activations per serving
    slot, of which the first ``n_new[b]`` rows are real tokens (the rest is
    bucket padding). k_pages/v_pages: (P, ps, K, Dh), this layer's pool;
    page_table: (B, MP) int32; start: (B,) int32 tokens already resident
    (the chunk occupies positions ``start .. start + n_new - 1``).

    Writes the chunk's K/V into the pool pages covering those positions IN
    PLACE (padding rows land on the reserved scratch page 0), then attends
    each chunk query causally to the resident context plus the in-chunk
    keys through the paged prefill kernel. ``pages_bound``: live bound on
    the page walk (every ``start + n_new`` must fit; None = the full table
    width). Returns out (B, C, D).
    """
    B, C, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ps = k_pages.shape[1]
    MP = page_table.shape[1]
    cap = MP * ps
    cols = torch.arange(C, device=x.device)
    positions = start[:, None] + cols[None, :]                    # (B, C)
    q, k_c, v_c = _project_qkv(attn, x, cfg, positions)
    # scatter the chunk's K/V into its pages: valid rows go to their page,
    # padding rows (c >= n_new) to the scratch page 0
    pos = torch.clamp(positions, max=cap - 1).long()
    valid = cols[None, :] < n_new[:, None]
    page = torch.gather(page_table.long(), 1, pos // ps)          # (B, C)
    page = torch.where(valid, page, 0)
    k_pages[page, pos % ps] = k_c
    v_pages[page, pos % ps] = v_c
    total = start + n_new
    G = H // K
    # c-major rows per kv head: (B, C, K, G, Dh) -> (B, K, C, G, Dh)
    qg = (q * Dh ** -0.5).reshape(B, C, K, G, Dh).permute(0, 2, 1, 3, 4)
    out = paged_prefill_attention_gqa(qg.contiguous(), k_pages, v_pages,
                                      page_table, start, total,
                                      pages_bound=pages_bound)
    out = out.permute(0, 2, 1, 3, 4).reshape(B, C, H, Dh)
    return _out_proj(attn, out, B, C, H, Dh)

"""Grouped-query attention with RoPE: the dense-cache paths and the paged
paths of ``repro.models.attention``.

Dense batch serving (``Engine``): ``prefill_attention`` runs the prompt
through ``attention_forward`` (causal flash attention) and returns the
layer's K/V for the (L, B, max_seq, K, Dh) cache; ``decode_attention``
writes one new token's K/V into that cache and attends to it, optionally
windowed (attention sink + the trailing positions). Training's
teacher-forced pass takes ``training_attention``, the plain version under
autograd. Continuous batching:
``paged_decode_attention`` (one new token per slot) and
``paged_prefill_attention`` (a chunk of prompt tokens per slot) write the
new K/V into the layer's page pool and attend through the paged kernels.
Every serving attention call goes through a kernel wrapper, which
launches the CUDA kernel for CUDA tensors and takes the plain version for
CPU tensors.

Cross-attention (``kv_override``), ``use_rope=False`` and non-causal
self-attention serve the encoder-decoder family, and the sequence-sharded
flash decode serves a multi-device mesh; each raises and names the slice
that brings it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention.ops import decode_attention_kv
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
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


def attention_forward(attn: Attention, x, cfg, *, is_global: bool = True,
                      causal: bool = True, positions=None, kv_override=None,
                      use_rope: bool = True):
    """Full-sequence causal self-attention. x: (B, S, D). ``is_global`` is
    this layer's static flag (the port loops over layers, so it is always
    a Python bool): False selects ``cfg.sliding_window``. Returns
    (B, S, D)."""
    if kv_override is not None or not use_rope or not causal:
        raise NotImplementedError(
            "cross-attention, use_rope=False and non-causal attention serve "
            "the encoder-decoder family, which comes with the "
            "encoder-decoder and frontends slice")
    return prefill_attention(attn, x, cfg, is_global=is_global,
                             positions=positions)[0]


def training_attention(attn: Attention, x, cfg, *, is_global: bool = True,
                       positions=None):
    """Full-sequence causal self-attention for training's teacher-forced
    pass, differentiable: the flash kernel's plain version (one masked
    softmax over the whole (S, S) score matrix) under autograd, on any
    device. No kernel launches here — the kernels have no backward pass,
    and the reference's training forward reaches none either. x: (B, S, D).
    Returns (B, S, D)."""
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(attn, x, cfg, positions)
    bhsd = lambda t: t.repeat_interleave(H // t.shape[2], 2).movedim(2, 1) \
        .reshape(B * H, S, Dh)
    window = cfg.sliding_window if not is_global else 0
    out = attention_ref(bhsd(q * Dh ** -0.5), bhsd(k), bhsd(v), causal=True,
                        window=window)
    return _out_proj(attn, out.reshape(B, H, S, Dh).movedim(1, 2), B, S, H,
                     Dh)


def init_kv_cache(cfg, batch: int, max_seq: int, n_layers: int,
                  device="cuda"):
    """Dense per-request cache: (n_layers, batch, max_seq, K, Dh) per
    tensor, zero-filled."""
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, max_seq, K, Dh)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill_attention(attn: Attention, x, cfg, *, is_global: bool = True,
                      positions=None):
    """Prefill: ``attention_forward`` plus this layer's (k, v), each
    (B, S, K, Dh), for cache insertion. q/k/v are projected once (the
    reference projects k and v twice; the values are the same)."""
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(attn, x, cfg, positions)
    window = cfg.sliding_window if not is_global else 0
    out = flash_attention(q * Dh ** -0.5, k, v, causal=True, window=window)
    return _out_proj(attn, out, B, S, H, Dh), (k, v)


def decode_attention(attn: Attention, x_t, layer_k, layer_v, pos: int, cfg,
                     *, is_global: bool = True, windowed: bool = False):
    """One decode step at position ``pos`` (a host int: every row of the
    dense batch sits at the same position).

    x_t: (B, 1, D); layer_k/layer_v: (B, Smax, K, Dh), this layer's slice of
    the dense cache, entries < pos valid. The new K/V are written at
    ``pos`` IN PLACE (the reference's ``dynamic_update_slice`` returns a new
    array). ``windowed``: long-context serving mode — attend only to an
    attention-sink prefix plus the trailing ``cfg.long_context_window``
    positions. Returns out (B, 1, D)."""
    B = x_t.shape[0]
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    Smax = layer_k.shape[1]
    if not 0 <= pos < Smax:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{Smax} positions")
    dev = x_t.device
    positions = torch.full((B, 1), pos, device=dev)
    q, k_t, v_t = _project_qkv(attn, x_t, cfg, positions)
    layer_k[:, pos] = k_t[:, 0]
    layer_v[:, pos] = v_t[:, 0]
    if windowed:
        W = min(cfg.long_context_window, Smax)
        sink = min(cfg.attention_sink, Smax)
        start = min(max(pos - W + 1, 0), Smax - W)
        keys = torch.cat([layer_k[:, :sink], layer_k[:, start:start + W]], 1)
        vals = torch.cat([layer_v[:, :sink], layer_v[:, start:start + W]], 1)
        sink_pos = torch.arange(sink, device=dev)
        # a sink position the window also holds is masked, not counted twice
        kpos = torch.cat([torch.where(sink_pos < start, sink_pos, pos + 1),
                          start + torch.arange(W, device=dev)])
    else:
        keys, vals = layer_k, layer_v
        kpos = torch.arange(Smax, device=dev)
    valid = kpos <= pos
    if cfg.sliding_window and not is_global:
        valid &= (pos - kpos) < cfg.sliding_window
    valid = valid.to(torch.int8)[None].expand(B, -1).contiguous()
    out = decode_attention_kv(q[:, 0] * Dh ** -0.5, keys, vals, valid)
    return _out_proj(attn, out, B, 1, H, Dh)


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
                           pages_bound=None, *, window=0, pages_start=0):
    """One decode step against a paged KV cache (continuous batching).

    x_t: (B, 1, D) — one new token per serving slot. k_pages/v_pages:
    (P, ps, K, Dh), this layer's pool; page_table: (B, MP) int32;
    seq_lens: (B,) int32 tokens already in each slot's cache (the new token
    lands at index seq_lens); active: (B,) bool — inactive slots write to
    the reserved scratch page 0 and their output is garbage the engine
    masks. ``pages_bound``: live bound on the kernel's page walk (every
    active slot's context must fit; None = the full table width).
    ``window``: this layer's sliding window (0 = global); ``pages_start``:
    the first walked page of a window layer (every active slot's first
    in-window key must be ``>= pages_start * ps``; 0 when ``window`` is 0).

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
                                     pages_bound=pages_bound,
                                     pages_start=pages_start, window=window)
    return _out_proj(attn, out.reshape(B, 1, H, Dh), B, 1, H, Dh)


def paged_prefill_attention(attn: Attention, x, k_pages, v_pages,
                            page_table, start, n_new, cfg, pages_bound=None,
                            *, window=0, pages_start=0):
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
    width). ``window``: this layer's sliding window (0 = global);
    ``pages_start``: the first walked page of a window layer (every row's
    earliest in-window key, ``start - window + 1``, must be
    ``>= pages_start * ps``). Returns out (B, C, D).
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
                                      pages_bound=pages_bound,
                                      pages_start=pages_start, window=window)
    out = out.permute(0, 2, 1, 3, 4).reshape(B, C, H, Dh)
    return _out_proj(attn, out, B, C, H, Dh)

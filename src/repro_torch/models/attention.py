"""Grouped-query attention with RoPE: the dense-cache paths, the paged
paths and the encoder-decoder's attentions of ``repro.models.attention``.

Dense batch serving (``Engine``): ``prefill_attention`` runs the prompt
through causal flash attention and returns the layer's K/V for the
(L, B, max_seq, K, Dh) cache; ``decode_attention`` writes one new token's
K/V into that cache and attends to it, optionally windowed (attention sink
+ the trailing positions). Training's teacher-forced pass takes
``training_attention``, the plain version under autograd. Continuous
batching: ``paged_decode_attention`` (one new token per slot) and
``paged_prefill_attention`` (a chunk of prompt tokens per slot) write the
new K/V into the layer's page pool and attend through the paged kernels.
Every serving self-attention call goes through a kernel wrapper, which
launches the CUDA kernel for CUDA tensors and takes the plain version for
CPU tensors.

The encoder-decoder family: ``attention_forward`` with ``causal=False``
and ``use_rope=False`` is the encoder's self-attention (the flash kernel's
non-causal mode); with ``kv_override`` it is cross-attention over the
encoder's K/V, which runs the plain masked softmax on any device (queries
and keys differ in count, and the reference, too, computes it outside any
kernel: its flash wrapper takes equal lengths only). In decode,
``decode_cross_attention`` reads a layer's (B, enc_seq, K, Dh) cross slab
in place through the dense decode kernel, every key valid.

On a launcher's mesh (DTensor weights, ``launch.dryrun``) each rank
computes its own shard of the projections and of the attention cores
(``sharding.layers``). Under ``sharding.context.flash_decode``
``decode_attention`` takes ``_flash_decode_seq_sharded`` over a cache
sequence-sharded on the mesh's "model" axis: plain PyTorch on each rank's
shard, combined by all-reduces, as the reference's shard_map is.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention.ops import decode_attention_kv
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_decode_attention.ops import \
    paged_decode_attention_gqa
from repro_torch.kernels.paged_prefill_attention.ops import \
    paged_prefill_attention_gqa
from repro_torch.sharding import context as shard_ctx
from repro_torch.sharding import layers as mesh_layers
from repro_torch.sharding.context import cache_zeros, flash_decode_ctx
from repro_torch.sharding.rules import placements
from .common import apply_rope, dtype_of, empty_param

NEG_INF = -1e30


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
    if hasattr(w, "device_mesh"):
        return mesh_layers.proj(x, w)
    return (x @ w.reshape(D, H * Dh)).reshape(*x.shape[:-1], H, Dh)


def _attend(kernel, q, k, v, q_pos, *, causal: bool, window: int,
            chunk: int):
    """Attention of q (B, Sq, H, Dh), pre-scaled, over k, v (B, Skv, K,
    Dh): ``kernel(q, k, v)`` (the flash wrapper), or, where ``kernel`` is
    None, the plain masked softmax by query chunks of ``chunk`` (the whole
    sequence when 0). On a launcher's mesh each rank attends its own rows
    (``sharding.layers.attend``)."""
    if any(hasattr(t, "device_mesh") for t in (q, k, v)):
        return mesh_layers.attend(kernel, q, k, v, q_pos, causal=causal,
                                  window=window, chunk=chunk)
    if kernel is not None:
        return kernel(q, k, v)
    return _chunked_attention(q, k, v, q_pos, causal=causal, window=window,
                              chunk=chunk or q.shape[1])


def _chunked_attention(q, k, v, q_pos, *, causal: bool, window: int,
                       chunk: int):
    """``_masked_attention`` over query chunks of ``chunk`` (one chunk when
    the queries are not a multiple of it)."""
    S = q.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    G = q.shape[2] // k.shape[2]
    if G > 1 and chunk < S:      # expand the KV heads once, not per chunk
        k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    return torch.cat([_masked_attention(q[:, i:i + chunk], k, v,
                                        q_pos[i:i + chunk], causal=causal,
                                        window=window)
                      for i in range(0, S, chunk)], 1)


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
    if hasattr(attn.wo, "device_mesh"):
        return mesh_layers.out_proj(attn.wo, out, B, S, H, Dh)
    return out.reshape(B, S, H * Dh) @ attn.wo


def _qkv(attn: Attention, x, cfg, positions, kv_override, use_rope):
    """The reference's projections: q, k and v with RoPE for
    self-attention (``_project_qkv``); otherwise q alone is projected (with
    its bias, RoPE only under ``use_rope``) and k, v are ``kv_override``
    or projected without RoPE."""
    if kv_override is None and use_rope:
        return _project_qkv(attn, x, cfg, positions)
    q = _proj(x, attn.wq)
    if cfg.qkv_bias:
        q = q + attn.bq
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_override is not None:
        k, v = kv_override
    else:
        k, v = _proj(x, attn.wk), _proj(x, attn.wv)
        if cfg.qkv_bias:
            k = k + attn.bk
            v = v + attn.bv
    return q, k, v


def _masked_attention(q, k, v, q_pos, *, causal: bool, window: int):
    """The plain masked softmax over any number of keys: q (B, Sq, H, Dh)
    pre-scaled at positions ``q_pos`` (Sq,), k and v (B, Skv, K, Dh) with
    key j at position j, query head h reading kv head h // (H // K).
    Returns (B, Sq, H, Dh)."""
    G = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(G, 2) if G > 1 else k
    vv = v.repeat_interleave(G, 2) if G > 1 else v
    s = torch.einsum("bqhd,bshd->bhqs", q, kk).float()
    k_pos = torch.arange(k.shape[1], device=q.device)
    allowed = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                         device=q.device)
    if causal:
        allowed &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        allowed &= (q_pos[:, None] - k_pos[None, :]) < window
    w = torch.softmax(torch.where(allowed, s, NEG_INF), dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", w.to(vv.dtype), vv)


def attention_forward(attn: Attention, x, cfg, *, is_global: bool = True,
                      causal: bool = True, positions=None, kv_override=None,
                      use_rope: bool = True):
    """Full-sequence attention. x: (B, S, D). ``is_global`` is this
    layer's static flag (the port loops over layers, so it is always a
    Python bool): False selects ``cfg.sliding_window``. ``kv_override``:
    (k, v), each (B, Skv, K, Dh), from an encoder for cross-attention
    (``positions`` then index the decoder side only); ``use_rope=False``
    applies no RoPE. Self-attention runs the flash kernel (causal or not);
    cross-attention the plain masked softmax by query chunks of
    ``cfg.attn_chunk`` (``_chunked_attention``) on any device. Returns (B,
    S, D)."""
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(attn, x, cfg, positions, kv_override, use_rope)
    window = cfg.sliding_window if not is_global else 0
    q_pos = positions if positions.ndim == 1 else positions[0]
    kernel = None       # cross-attention: the plain masked softmax
    if kv_override is None:
        kernel = lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                                 window=window)
    out = _attend(kernel, q * Dh ** -0.5, k, v, q_pos, causal=causal,
                  window=window, chunk=cfg.attn_chunk)
    return _out_proj(attn, out, B, S, H, Dh)


def training_attention(attn: Attention, x, cfg, *, is_global: bool = True,
                       causal: bool = True, positions=None, kv_override=None,
                       use_rope: bool = True):
    """``attention_forward`` for training's teacher-forced pass,
    differentiable: the plain masked softmax under autograd for
    self-attention, on any device, chunked over queries by
    ``cfg.attn_chunk`` as the reference chunks it (one chunk when S is not
    a multiple), so no (S, S) score matrix is built whole; cross-attention
    is ``attention_forward``'s, plain already. No kernel launches here —
    the kernels have no backward pass, and the reference's training
    forward reaches none either. x: (B, S, D). Returns (B, S, D)."""
    if kv_override is not None:
        return attention_forward(attn, x, cfg, is_global=is_global,
                                 causal=causal, positions=positions,
                                 kv_override=kv_override, use_rope=use_rope)
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(attn, x, cfg, positions, None, use_rope)
    window = cfg.sliding_window if not is_global else 0
    q_pos = positions if positions.ndim == 1 else positions[0]
    out = _attend(None, q * Dh ** -0.5, k, v, q_pos, causal=causal,
                  window=window, chunk=cfg.attn_chunk)
    return _out_proj(attn, out, B, S, H, Dh)


def init_kv_cache(cfg, batch: int, max_seq: int, n_layers: int,
                  device="cuda", like=None):
    """Dense per-request cache: (n_layers, batch, max_seq, K, Dh) per
    tensor, zero-filled (sharded like ``like`` under a launcher's
    activation-sharding context: ``sharding.context.cache_zeros``)."""
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, max_seq, K, Dh)
    dt = dtype_of(cfg)
    return {n: cache_zeros(n, shape, dt, device, batch, like)
            for n in ("k", "v")}


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
    q_pos = positions if positions.ndim == 1 else positions[0]
    out = _attend(lambda q, k, v: flash_attention(q, k, v, causal=True,
                                                  window=window),
                  q * Dh ** -0.5, k, v, q_pos, causal=True, window=window,
                  chunk=cfg.attn_chunk)
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
    positions. Under ``flash_decode`` a global layer of a stack without
    window layers (the reference's static-flag condition) over a cache
    sequence-sharded on "model" takes ``_flash_decode_seq_sharded``.
    Returns out (B, 1, D)."""
    B = x_t.shape[0]
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    Smax = layer_k.shape[1]
    if not 0 <= pos < Smax:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{Smax} positions")
    dev = x_t.device
    positions = torch.full((B, 1), pos, device=dev)
    q, k_t, v_t = _project_qkv(attn, x_t, cfg, positions)
    fctx = flash_decode_ctx()
    if (fctx is not None and not windowed and is_global
            and not cfg.has_window_layers
            and _seq_sharded(layer_k, fctx[0])):
        out = _flash_decode_seq_sharded(q * Dh ** -0.5, layer_k, layer_v,
                                        k_t, v_t, pos, H, *fctx)
        return _out_proj(attn, out, B, 1, H, Dh)
    shard_ctx.write_seq(layer_k, pos, k_t)
    shard_ctx.write_seq(layer_v, pos, v_t)
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
    out = _decode_core(q[:, 0] * Dh ** -0.5, keys, vals, valid)
    return _out_proj(attn, out, B, 1, H, Dh)


def _decode_core(q, keys, vals, valid):
    """``decode_attention_kv`` (q (B, H, Dh), keys/vals (B, S, K, Dh),
    valid (B, S) int8); on a launcher's mesh on each rank's rows
    (``sharding.layers.decode_core``)."""
    if any(hasattr(t, "device_mesh") for t in (q, keys, vals)):
        return mesh_layers.decode_core(decode_attention_kv, q, keys, vals,
                                       valid)
    return decode_attention_kv(q, keys, vals, valid)


def _seq_sharded(layer_k, mesh) -> bool:
    """True when ``layer_k`` (B, S, K, Dh) is a DTensor on ``mesh`` whose
    sequence dim is sharded on "model" and divides it."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(layer_k, DTensor) or "model" not in mesh.mesh_dim_names:
        return False
    m = mesh.mesh_dim_names.index("model")
    return (layer_k.placements[m] == Shard(1)
            and layer_k.shape[1] % mesh.shape[m] == 0)


def _flash_decode_seq_sharded(q, layer_k, layer_v, k_t, v_t, pos: int,
                              n_heads: int, mesh, batch_axes=None):
    """Flash decode over a sequence-sharded KV cache (the reference's
    shard_map over "model").

    q: (B, 1, H, Dh) pre-scaled; layer_k/v: (B, S, K, Dh) DTensors sharded
    S -> "model" (batch optionally on ``batch_axes``); k_t/v_t: (B, 1, K,
    Dh). Each rank writes the new K/V into its shard only if it owns
    ``pos`` (in place), computes its local max, denominator and weighted
    sum in plain PyTorch, and all-reduces them over the "model" group
    (MAX for the max, SUM for the other two): (B, H, 1, 1) and (B, 1, H,
    Dh) each, instead of gathering the cache. Returns (B, 1, H, Dh), a
    DTensor batch-sharded as the cache and replicated over "model"."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    shard_ctx.write_seq(layer_k, pos, k_t)      # on the rank that holds pos
    shard_ctx.write_seq(layer_v, pos, v_t)
    rows = placements((batch_axes, None, None, None), mesh)
    q = shard_ctx.local_shard(q, mesh, (batch_axes, None, None, None))
    k, v = layer_k.to_local(), layer_v.to_local()
    group = (mesh, mesh.mesh_dim_names.index("model"))
    S_loc = k.shape[1]
    start = mesh.get_local_rank("model") * S_loc
    G = n_heads // k.shape[2]
    kk = k.repeat_interleave(G, 2) if G > 1 else k
    vv = v.repeat_interleave(G, 2) if G > 1 else v
    s = torch.einsum("bqhk,bshk->bhqs", q, kk).float()
    kpos = start + torch.arange(S_loc, device=s.device)
    s = torch.where(kpos <= pos, s, NEG_INF)
    m = funcol.all_reduce(s.amax(-1, keepdim=True), "max", group)
    p = torch.exp(s - m)
    l = funcol.all_reduce(p.sum(-1, keepdim=True), "sum", group)
    o = funcol.all_reduce(torch.einsum("bhqs,bshk->bqhk", p.to(vv.dtype),
                                       vv).float(), "sum", group)
    out = o / torch.clamp(l.transpose(1, 2), min=1e-30)
    return DTensor.from_local(out.to(q.dtype), mesh, rows, run_check=False)


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


def decode_cross_attention(attn: Attention, x_t, enc_k, enc_v, cfg,
                           valid=None):
    """Cross-attention decode step against fixed encoder memory (no cache
    update). x_t: (B, 1, D); enc_k, enc_v: (B, enc_seq, K, Dh), a layer's
    slice of the cross cache, read in place by the dense decode kernel;
    ``valid``: (B, enc_seq) int8, every key valid (``encdec_prefill``
    builds it once a prefill; built here when None). With every key valid
    the kernel computes the reference's unmasked softmax. q is projected
    without its bias, as the reference projects it. Returns (B, 1, D)."""
    B = x_t.shape[0]
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    q = _proj(x_t, attn.wq)
    if valid is None:
        valid = torch.ones((B, enc_k.shape[1]), dtype=torch.int8,
                           device=x_t.device)
    out = _decode_core(q[:, 0] * Dh ** -0.5, enc_k, enc_v, valid)
    return _out_proj(attn, out, B, 1, H, Dh)

"""The Jamba-style hybrid Mamba/attention architecture (arXiv:2403.19887;
the port of ``repro.models.hybrid``). This is a model family; the router
over two serving tiers is ``serving.hybrid.HybridEngine``.

Layout: blocks of ``attn_every`` (8) layers, one attention layer a block
at ``attn_offset`` (4), the rest SSD (Mamba-2) mixers; the FFN after each
mixer is a routed MoE every ``moe_every`` (2) layers (odd positions) and
a SwiGLU MLP elsewhere. The reference scans over blocks with each block's
weights stacked by kind; here ``blocks`` is a ``ModuleList`` and each
block holds its sub-layers in ``ModuleList``s by kind, in layout order.

Serving state: the attention layers' K/V live in (n_blocks, ...) dense
slabs or page pools, one attention layer a block; the Mamba layers' SSD
state and conv tail in (n_blocks, n_mamba, ...) dense slabs, or in the
recurrent-state pool's rows (n_rows, n_blocks, n_mamba, ...) on the paged
path. Caches, pools and rows are updated in place. On the card the
attention layers run the paged kernels (decode, chunked prefill) or the
flash and dense decode kernels, and each Mamba prefill runs the SSD chunk
kernel; the teacher-forced ``hybrid_forward`` launches none. ``cfg.remat``
checkpoints each sub-layer (mixer + FFN) of ``hybrid_forward``, and the
loops pin activations batch-sharded where the reference does
(``sharding.context.constrain_batch``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.context import (cache_zeros, constrain_batch,
                                          write_seq)
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .common import (MLP, Embedding, OutputHead, RMSNorm, dtype_of, embed,
                     init_params_, mlp, remat, rmsnorm)
from .decoder import SSMLayer, _unembed


def _block_layout(cfg):
    """Per-position (mixer, ffn) kinds within one block."""
    pos = []
    for j in range(cfg.attn_every):
        mixer = "attn" if j == cfg.attn_offset else "mamba"
        ffn = "moe" if (cfg.moe_every and j % cfg.moe_every == 1) else "mlp"
        pos.append((mixer, ffn))
    return pos


def _sublayers(cfg):
    """[(mixer, Mamba index, ffn, index among that ffn kind)] for each
    position of a block, in layout order."""
    out, seen = [], {"mamba": 0, "moe": 0, "mlp": 0}
    for mixer, ffn in _block_layout(cfg):
        out.append((mixer, seen["mamba"], ffn, seen[ffn]))
        seen[ffn] += 1
        if mixer == "mamba":
            seen["mamba"] += 1
    return out


def _counts(cfg):
    """(n_blocks, n_mamba, n_moe, n_mlp)."""
    layout = _block_layout(cfg)
    n_moe = sum(f == "moe" for _, f in layout)
    return (cfg.n_layers // cfg.attn_every,
            sum(m == "mamba" for m, _ in layout), n_moe, len(layout) - n_moe)


class _AttnSub(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, dtype_of(cfg), device)
        self.attn = attn.Attention(cfg, device)


class _MoESub(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln2 = RMSNorm(cfg.d_model, dtype_of(cfg), device)
        self.moe = moe_lib.MoE(cfg, device)


class _MLPSub(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        dt = dtype_of(cfg)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class HybridBlock(nn.Module):
    """One block: ``mamba.<j>.{ln,ssm}``, ``attn.{ln1,attn}``,
    ``moe.<j>.{ln2,moe}`` and ``mlp.<j>.{ln2,mlp}``, each kind in layout
    order (the reference's ``blocks/<kind>/...`` stacked on the kind's
    axis)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _, n_mamba, n_moe, n_mlp = _counts(cfg)
        self.mamba = nn.ModuleList(SSMLayer(cfg, device)
                                   for _ in range(n_mamba))
        self.attn = _AttnSub(cfg, device)
        self.moe = nn.ModuleList(_MoESub(cfg, device) for _ in range(n_moe))
        self.mlp = nn.ModuleList(_MLPSub(cfg, device) for _ in range(n_mlp))


class Hybrid(nn.Module):
    """``embed.table``, ``blocks.<b>.*`` (``HybridBlock``), ``ln_f.scale``
    and, untied, ``head.w``. Built empty on ``device``; fill with
    ``init_hybrid`` or the bridge."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dt = dtype_of(cfg)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dt, device)
        self.blocks = nn.ModuleList(HybridBlock(cfg, device)
                                    for _ in range(_counts(cfg)[0]))
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.head = OutputHead(cfg.d_model, cfg.padded_vocab, dt, device)


def init_hybrid(cfg, generator, device="cuda") -> Hybrid:
    """A hybrid stack with weights drawn from the reference's init
    distributions through ``generator`` (on ``device``)."""
    return init_params_(Hybrid(cfg, device), generator)


def _apply_ffn(block: HybridBlock, x, ffn: str, j: int, cfg):
    """x plus the FFN at its position; returns (x, aux), aux the MoE
    layer's load-balance loss or None."""
    if ffn == "moe":
        sub = block.moe[j]
        y, aux = moe_lib.moe_forward(sub.moe, rmsnorm(sub.ln2, x,
                                                      cfg.norm_eps), cfg)
        return x + y, aux
    sub = block.mlp[j]
    return x + mlp(sub.mlp, rmsnorm(sub.ln2, x, cfg.norm_eps)), None


def _mamba_in(block: HybridBlock, j: int, x, cfg):
    sub = block.mamba[j]
    return sub.ssm, rmsnorm(sub.ln, x, cfg.norm_eps)


def _attn_in(block: HybridBlock, x, cfg):
    return block.attn.attn, rmsnorm(block.attn.ln1, x, cfg.norm_eps)


# ------------------------------------------------------------------ forward
def _forward_sublayer(block: HybridBlock, x, cfg, sub, positions):
    """One (mixer + FFN) sub-layer of the teacher-forced pass: (x, the
    MoE aux or None)."""
    mixer, jm, ffn, jf = sub
    if mixer == "attn":
        a, h = _attn_in(block, x, cfg)
        x = x + attn.training_attention(a, h, cfg, positions=positions)
    else:
        x = x + ssm_lib.ssm_forward(*_mamba_in(block, jm, x, cfg), cfg)
    x, aux = _apply_ffn(block, x, ffn, jf, cfg)
    return constrain_batch(x), aux


def hybrid_forward(model: Hybrid, batch: dict, cfg):
    """Teacher-forced forward over ``batch["tokens"]`` (B, S). Returns
    (logits (B, S, V), aux summed over the MoE layers). Differentiable,
    and no kernel launches (``attention.training_attention``,
    ``ssm.ssm_forward``)."""
    tokens = batch["tokens"]
    x = embed(model.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in model.blocks:
        for sub in _sublayers(cfg):
            x, layer_aux = remat(cfg, _forward_sublayer, block, x, cfg, sub,
                                 positions)
            if layer_aux is not None:
                aux = aux + layer_aux
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg), aux


# -------------------------------------------------------------- dense cache
def _state_zeros(cfg, lead, device, batch=0, like=None):
    """Zero Mamba state {"h": lead + (H, P, N) fp32, "conv": lead +
    (cw - 1, di + 2 N)} (a dense cache's is sharded like ``like``:
    ``sharding.context.cache_zeros``)."""
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    tail = (cfg.ssm_conv_width - 1, cfg.d_inner + 2 * N)
    return {"h": cache_zeros("ssm_h", lead + (H, P, N), torch.float32,
                             device, batch, like),
            "conv": cache_zeros("ssm_conv", lead + tail, dtype_of(cfg),
                                device, batch, like)}


def init_hybrid_cache(cfg, batch: int, max_seq: int, device="cuda",
                      like=None):
    """Dense serving cache: K/V {"k", "v": (n_blocks, B, max_seq, K, Dh)},
    SSD state "ssm_h" (n_blocks, n_mamba, B, H, P, N) fp32, raw conv tail
    "ssm_conv" (n_blocks, n_mamba, B, cw - 1, di + 2 N), "pos" 0."""
    nb, nm, _, _ = _counts(cfg)
    kv = attn.init_kv_cache(cfg, batch, max_seq, nb, device, like)
    st = _state_zeros(cfg, (nb, nm, batch), device, batch, like)
    return {"k": kv["k"], "v": kv["v"], "ssm_h": st["h"],
            "ssm_conv": st["conv"], "pos": 0}


def hybrid_prefill(model: Hybrid, batch: dict, cfg, max_seq=None):
    """Run the prompt ``batch["tokens"]`` (B, S); return (last-token logits
    (B, V), cache). The K/V slabs are sized ``max_seq`` (>= S), so decode
    appends in place; ``cache["pos"]`` is S, a host int."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_seq = max(max_seq or S, S)
    x = embed(model.embed, tokens)
    cache = init_hybrid_cache(cfg, B, max_seq, tokens.device, like=x)
    positions = torch.arange(S, device=x.device)
    for b, block in enumerate(model.blocks):
        for mixer, jm, ffn, jf in _sublayers(cfg):
            if mixer == "attn":
                o, (k, v) = attn.prefill_attention(
                    *_attn_in(block, x, cfg), cfg, positions=positions)
                write_seq(cache["k"][b], 0, k)
                write_seq(cache["v"][b], 0, v)
                x = x + o
            else:
                y, cache["ssm_h"][b, jm], cache["ssm_conv"][b, jm] = \
                    ssm_lib.ssm_prefill(*_mamba_in(block, jm, x, cfg), cfg)
                x = x + y
            x = _apply_ffn(block, x, ffn, jf, cfg)[0]
        x = constrain_batch(x)
    cache["pos"] = S
    x = rmsnorm(model.ln_f, x[:, -1:], cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0], cache


def hybrid_decode_step(model: Hybrid, cache, token, cfg, *,
                       windowed: bool = False):
    """One decode step, token (B, 1): the new K/V land at ``cache["pos"]``
    and the SSD state and conv tails advance, all IN PLACE; ``pos``
    advances. Returns (logits (B, V), cache)."""
    pos = cache["pos"]
    x = embed(model.embed, token)
    for b, block in enumerate(model.blocks):
        for mixer, jm, ffn, jf in _sublayers(cfg):
            if mixer == "attn":
                x = x + attn.decode_attention(
                    *_attn_in(block, x, cfg), cache["k"][b], cache["v"][b],
                    pos, cfg, windowed=windowed)
            else:
                y, cache["ssm_h"][b, jm], cache["ssm_conv"][b, jm] = \
                    ssm_lib.ssm_decode_step(
                        *_mamba_in(block, jm, x, cfg), cache["ssm_h"][b, jm],
                        cache["ssm_conv"][b, jm], cfg)
                x = x + y
            x = _apply_ffn(block, x, ffn, jf, cfg)[0]
        x = constrain_batch(x)
    cache["pos"] = pos + 1
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0], cache


# --------------------------------------------------------------------- paged
def init_hybrid_paged_cache(cfg, num_pages: int, page_size: int,
                            device="cuda"):
    """Page pools for the attention layers, one a block: (n_blocks,
    num_pages, page_size, K, Dh) per tensor, page 0 the scratch page. The
    Mamba layers' state lives in the recurrent-state pool
    (``init_hybrid_recurrent_state``)."""
    if not cfg.supports_paged_kv:
        raise ValueError(f"{cfg.name}: no paged serving path "
                         f"({cfg.paged_unsupported_reason})")
    return attn.init_paged_kv_cache(cfg, num_pages, page_size,
                                    _counts(cfg)[0], device)


def init_hybrid_recurrent_state(cfg, n_rows: int, device="cuda"):
    """Recurrent-state rows for the serving slots: SSD state ``h``
    (n_rows, n_blocks, n_mamba, H, P, N) fp32 and raw conv tail ``conv``
    (n_rows, n_blocks, n_mamba, cw - 1, di + 2 N). Row 0 is the scratch
    row; slot ``s`` owns row ``s + 1``
    (``serving.cache.RecurrentStatePool``)."""
    nb, nm, _, _ = _counts(cfg)
    return _state_zeros(cfg, (n_rows, nb, nm), device)


def hybrid_prefill_paged_chunk(model: Hybrid, cache, tokens, page_table,
                               start, n_new, cfg, pages_bound=None,
                               window_start=0, state_rows=None):
    """One chunked-prefill step (continuous batching). tokens (B, C) int,
    PAD past ``n_new[b]``; page_table (B, MP) rows already cover positions
    ``start .. start + n_new - 1``. Attention layers write the chunk's K/V
    into their pool and attend causally by global position; Mamba layers
    stream each row's state from ``cache["rec"]`` row ``state_rows[b]``
    (0 = the scratch row of padding rows) and write it back IN PLACE. A row
    whose chunk starts at 0 re-enters from zero state, so slot reuse needs
    no reset. Returns x_last (B, 1, D), the final-norm hidden state of token
    ``start + n_new - 1`` (the engine applies the LM head). The attention
    layers are global, so ``window_start`` is unused (kept for the
    bundle's signature)."""
    del window_start
    B, C = tokens.shape
    rec, rows = cache["rec"], state_rows.long()
    fresh = (start == 0)
    h0 = torch.where(fresh[:, None, None, None, None, None], 0.0,
                     rec["h"][rows])                    # (B, nb, nm, ...)
    tails = torch.where(fresh[:, None, None, None, None], 0.0,
                        rec["conv"][rows]).to(rec["conv"].dtype)
    hs, ts = torch.empty_like(h0), torch.empty_like(tails)
    x = embed(model.embed, tokens)
    for b, block in enumerate(model.blocks):
        for mixer, jm, ffn, jf in _sublayers(cfg):
            if mixer == "attn":
                x = x + attn.paged_prefill_attention(
                    *_attn_in(block, x, cfg), cache["k_pages"][b],
                    cache["v_pages"][b], page_table, start, n_new, cfg,
                    pages_bound)
            else:
                y, hs[:, b, jm], ts[:, b, jm] = ssm_lib.ssm_prefill_chunk(
                    *_mamba_in(block, jm, x, cfg), h0[:, b, jm],
                    tails[:, b, jm], n_new, cfg)
                x = x + y
            x = _apply_ffn(block, x, ffn, jf, cfg)[0]
        x = constrain_batch(x)
    # padding rows all write the scratch row 0, which no slot reads
    rec["h"][rows] = hs
    rec["conv"][rows] = ts
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    last = torch.clamp(n_new.long() - 1, 0, C - 1)
    return x[torch.arange(B, device=x.device), last][:, None]


def hybrid_decode_step_paged(model: Hybrid, cache, token, page_table,
                             seq_lens, active, cfg, pages_bound=None,
                             window_start=0):
    """One continuous-batching decode step, token (B, 1) a slot. Attention
    layers write the new K/V into their pool and run the paged decode
    kernel; Mamba layers advance ``cache["rec"]`` rows 1..B IN PLACE (row 0
    is scratch), and the rows of slots not in ``active`` keep their state,
    so a decode step never disturbs a slot still mid-prefill. Returns
    logits (B, V). ``window_start`` is unused (global attention)."""
    del window_start
    rec, act = cache["rec"], active.reshape(-1)
    x = embed(model.embed, token)
    for b, block in enumerate(model.blocks):
        for mixer, jm, ffn, jf in _sublayers(cfg):
            if mixer == "attn":
                x = x + attn.paged_decode_attention(
                    *_attn_in(block, x, cfg), cache["k_pages"][b],
                    cache["v_pages"][b], page_table, seq_lens, active, cfg,
                    pages_bound)
            else:
                h_st, tail = rec["h"][1:, b, jm], rec["conv"][1:, b, jm]
                y, h_new, tail_new = ssm_lib.ssm_decode_step(
                    *_mamba_in(block, jm, x, cfg), h_st, tail, cfg)
                h_st.copy_(torch.where(act[:, None, None, None], h_new,
                                       h_st))
                tail.copy_(torch.where(act[:, None, None], tail_new, tail))
                x = x + y
            x = _apply_ffn(block, x, ffn, jf, cfg)[0]
        x = constrain_batch(x)
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0]

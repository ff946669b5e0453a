"""Decoder-only LM, dense and SSM families: the dense-cache serving path
and the paged serving path of ``repro.models.decoder``.

The reference stacks layer weights on a leading axis and ``lax.scan``s
over them; here layers are a ``ModuleList`` and the scan is a Python loop,
so each layer's global/local flag is a static bool. Each layer reads and
writes its own slice ``cache[...][i]`` of the (L, B, max_seq, K, Dh) dense
cache or the (L, P, ps, K, Dh) page pools, which is contiguous, so the
kernels take it as it is. The SSM family (``family="ssm"``, attention-free
SSD blocks) keeps constant-size recurrent state instead: (L, B, ...) slabs
in the dense cache, and per-slot rows of a recurrent-state pool
(``cache["rec"]``, rows (n_slots + 1, L, ...)) on the paged path, whose
page pools then have zero layers. Dense stacks may mix global and
sliding-window layers (gemma3's 5 local : 1 global): a window layer passes
its static ``cfg.layer_window(i)`` to the kernels, and on the paged path
starts its page walk at the engine's ``window_start`` (global layers walk
from page 0). Dense and SSM stacks are built so far
(``models.model.build_model`` refuses the rest). ``decoder_forward`` is
training's teacher-forced pass, for dense stacks: differentiable, and it
launches no kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import attention as attn
from . import ssm as ssm_lib
from .common import (MLP, Embedding, OutputHead, RMSNorm, dtype_of, embed,
                     init_params_, mlp, output_head, rmsnorm, unembed)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class SSMLayer(nn.Module):
    """An attention-free SSD block (``family="ssm"``): ``ln``, then the
    ``ssm`` mixer."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype_of(cfg), device)
        self.ssm = ssm_lib.SSM(cfg, device)


class Decoder(nn.Module):
    """Parameter names follow the reference tree: ``embed.table``,
    ``layers.<i>.{ln1,attn,ln2,mlp}.*`` (``layers.<i>.{ln,ssm}.*`` for the
    SSM family), ``ln_f.scale`` and, untied, ``head.w``. Built empty on
    ``device``; fill with ``init_decoder`` or the bridge."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dt = dtype_of(cfg)
        layer = SSMLayer if cfg.family == "ssm" else DecoderLayer
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.head = OutputHead(cfg.d_model, cfg.padded_vocab, dt, device)


def init_decoder(cfg, generator, device="cuda") -> Decoder:
    """A decoder with weights drawn from the reference's init
    distributions through ``generator`` (on ``device``)."""
    return init_params_(Decoder(cfg, device), generator)


def _unembed(model: Decoder, x, cfg):
    if cfg.tie_embeddings:
        return unembed(model.embed, x, cfg.vocab_size)
    return output_head(model.head, x, cfg.vocab_size)


def decoder_prefill(model: Decoder, batch: dict, cfg, max_seq=None):
    """Run the prompt ``batch["tokens"]`` (B, S) int; return (last-token
    logits (B, V), cache). The cache's K/V slabs are sized ``max_seq``
    (>= S) so decode appends in place (the SSM family's state slabs have
    no sequence axis); ``cache["pos"]`` is S, a host int."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_seq = max(max_seq or S, S)
    cache = init_decode_cache(cfg, B, max_seq, tokens.device)
    x = embed(model.embed, tokens)
    positions = torch.arange(S, device=x.device)
    for i, layer in enumerate(model.layers):
        if cfg.family == "ssm":
            y, cache["ssm_h"][i], cache["ssm_conv"][i] = _ssm_prefill_layer(
                layer.ssm, rmsnorm(layer.ln, x, cfg.norm_eps), cfg)
            x = x + y
            continue
        is_global = cfg.layer_kind(i)["global_attn"]
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        o, (k, v) = attn.prefill_attention(layer.attn, h, cfg,
                                           is_global=is_global,
                                           positions=positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        x = x + o
        x = x + mlp(layer.mlp, rmsnorm(layer.ln2, x, cfg.norm_eps))
    cache["pos"] = S
    x = rmsnorm(model.ln_f, x[:, -1:], cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0], cache


def decoder_forward(model: Decoder, batch: dict, cfg):
    """Teacher-forced forward over ``batch["tokens"]`` (B, S) int. Returns
    (logits (B, S, V) over the padded vocab, tail masked; aux, a 0-d fp32
    zero: a dense stack has no MoE load-balance loss). Differentiable: the
    attention is the plain masked softmax under autograd
    (``attention.training_attention``; the reference chunks queries by
    ``attn_chunk``, which gives the same values), and no kernel launches.
    The SSM family's ``ssm_forward`` comes with a later slice."""
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the SSM family's teacher-forced forward "
            "(ssm_forward) comes with the dense ssm_forward slice; no tier "
            "of the routing pipeline is an SSM")
    tokens = batch["tokens"]
    x = embed(model.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i, layer in enumerate(model.layers):
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.training_attention(
            layer.attn, h, cfg, is_global=cfg.layer_kind(i)["global_attn"],
            positions=positions)
        x = x + mlp(layer.mlp, rmsnorm(layer.ln2, x, cfg.norm_eps))
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def _ssm_prefill_layer(ssm, h, cfg):
    """The mixer over a whole prompt h (B, S, D), S padded to a multiple of
    ``cfg.ssm_chunk`` with dt = 0 rows (which leave the state as it is).
    Returns (y (B, S, D), final state (B, H, P, N), raw conv tail
    (B, cw - 1, di + 2 N) for decoding)."""
    Bsz, S, _ = h.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    cw = cfg.ssm_conv_width
    z, xBC_raw, dt_raw = ssm_lib._split_proj(h @ ssm.w_in, cfg)
    xBC = ssm_lib._causal_conv(xBC_raw, ssm.conv_w)
    xs = xBC[..., :di].reshape(Bsz, S, H, P)
    Bmat, Cmat = xBC[..., di:di + N], xBC[..., di + N:]
    dt = F.softplus(dt_raw.float() + ssm.dt_bias)
    pad = (-S) % cfg.ssm_chunk
    xs_p, dt_p, B_p, C_p = xs, dt, Bmat, Cmat
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt_p, B_p, C_p = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bmat, Cmat))
    y, final = ssm_lib.ssd_chunked(xs_p, dt_p, -torch.exp(ssm.A_log), B_p,
                                   C_p, cfg.ssm_chunk)
    if S < cw - 1:   # tiny prompts: left-pad the tail with zeros
        tail = F.pad(xBC_raw, (0, 0, cw - 1 - S, 0))
    else:
        tail = xBC_raw[:, S - (cw - 1):]
    return ssm_lib._gate_out(ssm, y[:, :S], xs, z, cfg), final, tail


def init_decode_cache(cfg, batch: int, max_seq: int, device="cuda"):
    """Dense KV cache {"k", "v": (L, B, max_seq, K, Dh), "pos": 0}; for the
    SSM family the state slabs {"ssm_h": (L, B, H, P, N) fp32, "ssm_conv":
    (L, B, cw - 1, di + 2 N), "pos": 0}."""
    if cfg.family == "ssm":
        st = ssm_lib.init_ssm_state(cfg, batch, cfg.n_layers, device)
        return {"ssm_h": st["h"], "ssm_conv": st["conv"], "pos": 0}
    kv = attn.init_kv_cache(cfg, batch, max_seq, cfg.n_layers, device)
    return {"k": kv["k"], "v": kv["v"], "pos": 0}


def decoder_decode_step(model: Decoder, cache, token, cfg, *,
                        windowed: bool = False):
    """One decode step. token: (B, 1) int. The new token's K/V land at
    ``cache["pos"]`` in every layer's slab IN PLACE (the SSM family's
    state slabs advance in place), and ``cache["pos"]`` advances; the same
    (updated) cache dict is returned. Returns (logits (B, V), cache)."""
    pos = cache["pos"]
    x = embed(model.embed, token)
    for i, layer in enumerate(model.layers):
        if cfg.family == "ssm":
            y, cache["ssm_h"][i], cache["ssm_conv"][i] = \
                ssm_lib.ssm_decode_step(
                    layer.ssm, rmsnorm(layer.ln, x, cfg.norm_eps),
                    cache["ssm_h"][i], cache["ssm_conv"][i], cfg)
            x = x + y
            continue
        is_global = cfg.layer_kind(i)["global_attn"]
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.decode_attention(layer.attn, h, cache["k"][i],
                                      cache["v"][i], pos, cfg,
                                      is_global=is_global,
                                      windowed=windowed)
        x = x + mlp(layer.mlp, rmsnorm(layer.ln2, x, cfg.norm_eps))
    cache["pos"] = pos + 1
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0], cache


def init_paged_decode_cache(cfg, num_pages: int, page_size: int,
                            device="cuda"):
    """Paged KV cache: one shared page pool per attention layer, layout
    (L, P, ps, K, Dh). Slot bookkeeping (page table, seq lens) lives with
    the serving engine's allocator, not in the cache. Attention-free stacks
    (family="ssm") get zero-layer pools: their serving state lives in the
    recurrent-state pool (``init_decoder_recurrent_state``)."""
    if not cfg.supports_paged_kv:
        raise ValueError(f"{cfg.name}: no paged serving path "
                         f"({cfg.paged_unsupported_reason})")
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers
    return attn.init_paged_kv_cache(cfg, num_pages, page_size, n_attn,
                                    device)


def init_decoder_recurrent_state(cfg, n_rows: int, device="cuda"):
    """Recurrent-state slabs for the SSM family's serving slots: SSD state
    ``h`` (n_rows, L, H, P, N) fp32 and raw conv tail ``conv``
    (n_rows, L, cw - 1, di + 2 N). Row 0 is the pool's scratch row
    (packed-prefill padding rows read and write it); slot ``s`` owns row
    ``s + 1`` (``serving.cache.RecurrentStatePool``)."""
    st = ssm_lib.init_ssm_state(cfg, n_rows, cfg.n_layers, device)
    return {"h": st["h"].movedim(0, 1).contiguous(),
            "conv": st["conv"].movedim(0, 1).contiguous()}


def _paged_chunk_attn_hidden(model: Decoder, cache, x, page_table, start,
                             n_new, cfg, pages_bound, window_start):
    """Run every layer over the embedded chunk ``x`` (B, C, D) — each
    writing the chunk's K/V into its pool pages and attending causally to
    resident context + in-chunk keys, a window layer within its window
    from page ``window_start`` on — then the final norm. Returns the
    post-norm hidden states (B, C, D) of every chunk position."""
    for i, layer in enumerate(model.layers):
        w = cfg.layer_window(i)
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.paged_prefill_attention(
            layer.attn, h, cache["k_pages"][i], cache["v_pages"][i],
            page_table, start, n_new, cfg, pages_bound, window=w,
            pages_start=window_start if w else 0)
        x = x + mlp(layer.mlp, rmsnorm(layer.ln2, x, cfg.norm_eps))
    return rmsnorm(model.ln_f, x, cfg.norm_eps)


def decoder_prefill_paged_chunk(model: Decoder, cache, tokens, page_table,
                                start, n_new, cfg, pages_bound=None,
                                window_start=0, state_rows=None):
    """One chunked-prefill step over the paged pool (continuous batching).

    tokens: (B, C) int — a fixed-width chunk of prompt tokens per serving
    slot, PAD-filled past ``n_new[b]``; page_table (B, MP) int32 rows
    already cover positions ``start .. start + n_new - 1``. Window layers
    start their page walk at ``window_start`` (the engine's bucketed first
    live window page; global layers walk from page 0). The pools in
    ``cache`` are updated in place. Returns x_last (B, 1, D), the
    final-norm hidden state of token ``start + n_new - 1``. The LM head is
    not applied here: only a prompt's final chunk needs logits, and the
    engine applies ``ModelBundle.lm_head`` to those alone.

    The SSM family advances per-slot recurrent state instead of pages:
    ``cache["rec"]`` rows are gathered by ``state_rows`` (B,) int32 (0 =
    the scratch row padding rows use), a row whose chunk starts at
    position 0 re-enters from zero state (slot reuse needs no reset), and
    the advanced rows are written back IN PLACE."""
    B, C = tokens.shape
    x = embed(model.embed, tokens)
    if cfg.family == "ssm":
        x = _ssm_chunk_hidden(model, cache["rec"], x, start, n_new,
                              state_rows.long(), cfg)
    else:
        x = _paged_chunk_attn_hidden(model, cache, x, page_table, start,
                                     n_new, cfg, pages_bound, window_start)
    last = torch.clamp(n_new.long() - 1, 0, C - 1)
    return x[torch.arange(B, device=x.device), last][:, None]


def _ssm_chunk_hidden(model: Decoder, rec, x, start, n_new, rows, cfg):
    """The SSM layers over the embedded chunk ``x`` (B, C, D), streaming
    each row's state from ``rec`` row ``rows[b]`` and writing it back, then
    the final norm. Returns the post-norm hidden states (B, C, D)."""
    fresh = (start == 0)
    # a prompt's first chunk starts from zero state, whatever the slot's
    # previous tenant left behind
    h0 = torch.where(fresh[:, None, None, None, None], 0.0, rec["h"][rows])
    tails = torch.where(fresh[:, None, None, None], 0.0,
                        rec["conv"][rows]).to(rec["conv"].dtype)
    hs, ts = [], []
    for i, layer in enumerate(model.layers):
        y, h_new, tail = ssm_lib.ssm_prefill_chunk(
            layer.ssm, rmsnorm(layer.ln, x, cfg.norm_eps), h0[:, i],
            tails[:, i], n_new, cfg)
        x = x + y
        hs.append(h_new)
        ts.append(tail)
    # every padding row writes the scratch row 0; which of them lands last
    # does not matter, since no slot ever reads row 0
    rec["h"][rows] = torch.stack(hs, 1)
    rec["conv"][rows] = torch.stack(ts, 1)
    return rmsnorm(model.ln_f, x, cfg.norm_eps)


def decoder_decode_step_paged(model: Decoder, cache, token, page_table,
                              seq_lens, active, cfg, pages_bound=None,
                              window_start=0):
    """One continuous-batching decode step over the serving slots.

    token: (B, 1) int — per-slot next token; page_table (B, MP) int32,
    seq_lens (B,) int32 and active (B,) bool come from the engine's page
    allocator; ``pages_bound`` is the engine's live page bound (None = the
    full table width) and ``window_start`` the first page of the window
    layers' walks (global layers walk from page 0). The pools in
    ``cache`` are updated in place.
    The SSM family advances ``cache["rec"]`` rows 1..B in place instead
    (row 0 is the scratch row); rows of slots not in ``active`` keep their
    state, so a decode step never disturbs a slot still mid-prefill.
    Returns logits (B, V)."""
    x = embed(model.embed, token)
    if cfg.family == "ssm":
        rec, act = cache["rec"], active.reshape(-1)
        for i, layer in enumerate(model.layers):
            h_st, tail = rec["h"][1:, i], rec["conv"][1:, i]
            y, h_new, tail_new = ssm_lib.ssm_decode_step(
                layer.ssm, rmsnorm(layer.ln, x, cfg.norm_eps), h_st, tail,
                cfg)
            h_st.copy_(torch.where(act[:, None, None, None], h_new, h_st))
            tail.copy_(torch.where(act[:, None, None], tail_new, tail))
            x = x + y
        x = rmsnorm(model.ln_f, x, cfg.norm_eps)
        return _unembed(model, x, cfg)[:, 0]
    for i, layer in enumerate(model.layers):
        w = cfg.layer_window(i)
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.paged_decode_attention(
            layer.attn, h, cache["k_pages"][i], cache["v_pages"][i],
            page_table, seq_lens, active, cfg, pages_bound, window=w,
            pages_start=window_start if w else 0)
        x = x + mlp(layer.mlp, rmsnorm(layer.ln2, x, cfg.norm_eps))
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0]

"""Decoder-only LM, the dense, MoE, SSM and vlm families: the dense-cache
serving path, the paged serving path and training's teacher-forced pass
of ``repro.models.decoder``. The vlm family (a stub vision frontend)
prepends its ``frontend_embeds`` to the token embeddings on the dense
path and in training, and has no paged path.

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
from page 0). A config with ``n_experts > 0`` (the MoE family, or a window
stack with MoE layers) puts a routed MoE FFN (``models.moe``) in every
layer in place of the MLP. ``decoder_forward`` is training's
teacher-forced pass for every family here: differentiable, it launches no
kernel, and it returns the MoE layers' load-balance aux summed over
layers. ``cfg.remat`` checkpoints each layer of ``decoder_forward``; the
layer loops pin their activations batch-sharded
(``sharding.context.constrain_batch``) where the reference does, a no-op
unless a launcher installed an activation-sharding context.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.context import constrain_batch, write_seq
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .common import (MLP, Embedding, OutputHead, RMSNorm, dtype_of, embed,
                     init_params_, mlp, output_head, remat, rmsnorm, unembed)


class DecoderLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, then the FFN: ``moe`` when the config
    has experts, else ``mlp``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        if cfg.n_experts > 0:
            self.moe = moe_lib.MoE(cfg, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


def _ffn(layer: DecoderLayer, x, cfg):
    """The layer's FFN on the normed ``x``: (y, aux), aux the MoE layer's
    load-balance loss, None for an MLP."""
    h = rmsnorm(layer.ln2, x, cfg.norm_eps)
    if cfg.n_experts > 0:
        return moe_lib.moe_forward(layer.moe, h, cfg)
    return mlp(layer.mlp, h), None


class SSMLayer(nn.Module):
    """An attention-free SSD block (``family="ssm"``): ``ln``, then the
    ``ssm`` mixer."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype_of(cfg), device)
        self.ssm = ssm_lib.SSM(cfg, device)


class Decoder(nn.Module):
    """Parameter names follow the reference tree: ``embed.table``,
    ``layers.<i>.{ln1,attn,ln2,mlp}.*`` (``moe`` in place of ``mlp`` with
    experts, ``layers.<i>.{ln,ssm}.*`` for the SSM family), ``ln_f.scale``
    and, untied, ``head.w``. Built empty on ``device``; fill with
    ``init_decoder`` or the bridge."""

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


def _embed_inputs(model: Decoder, batch: dict, cfg):
    """Token embeddings, with ``batch["frontend_embeds"]`` (B, n_front, D)
    prepended for the vlm family's stub frontend."""
    x = embed(model.embed, batch["tokens"])
    if cfg.frontend_positions:
        x = torch.cat([batch["frontend_embeds"].to(x.dtype), x], dim=1)
    return constrain_batch(x)


def decoder_prefill(model: Decoder, batch: dict, cfg, max_seq=None):
    """Run the prompt ``batch["tokens"]`` (B, S) int, behind
    ``batch["frontend_embeds"]`` for the vlm family; return (last-token
    logits (B, V), cache). S counts the frontend positions too. The
    cache's K/V slabs are sized ``max_seq`` (>= S) so decode appends in
    place (the SSM family's state slabs have no sequence axis);
    ``cache["pos"]`` is S, a host int, so decode continues at position
    n_front + tokens."""
    x = _embed_inputs(model, batch, cfg)
    B, S = x.shape[:2]
    max_seq = max(max_seq or S, S)
    cache = init_decode_cache(cfg, B, max_seq, x.device, like=x)
    positions = torch.arange(S, device=x.device)
    for i, layer in enumerate(model.layers):
        if cfg.family == "ssm":
            y, cache["ssm_h"][i], cache["ssm_conv"][i] = ssm_lib.ssm_prefill(
                layer.ssm, rmsnorm(layer.ln, x, cfg.norm_eps), cfg)
            x = constrain_batch(x + y)
            continue
        is_global = cfg.layer_kind(i)["global_attn"]
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        o, (k, v) = attn.prefill_attention(layer.attn, h, cfg,
                                           is_global=is_global,
                                           positions=positions)
        write_seq(cache["k"][i], 0, k)
        write_seq(cache["v"][i], 0, v)
        x = x + o
        x = constrain_batch(x + _ffn(layer, x, cfg)[0])
    cache["pos"] = S
    x = rmsnorm(model.ln_f, x[:, -1:], cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0], cache


def _forward_layer(layer, x, cfg, is_global: bool, positions):
    """One layer of the teacher-forced pass: (x, the MoE aux or None)."""
    if cfg.family == "ssm":
        y = ssm_lib.ssm_forward(layer.ssm, rmsnorm(layer.ln, x, cfg.norm_eps),
                                cfg)
        return constrain_batch(x + y), None
    h = rmsnorm(layer.ln1, x, cfg.norm_eps)
    x = x + attn.training_attention(layer.attn, h, cfg, is_global=is_global,
                                    positions=positions)
    y, aux = _ffn(layer, x, cfg)
    return constrain_batch(x + y), aux


def decoder_forward(model: Decoder, batch: dict, cfg):
    """Teacher-forced forward over ``batch["tokens"]`` (B, S) int. Returns
    (logits (B, S, V) over the padded vocab, tail masked; aux, the MoE
    layers' load-balance losses summed over layers, a 0-d fp32 zero
    without experts). Differentiable, and no kernel launches: the
    attention is the plain masked softmax under autograd
    (``attention.training_attention``, chunked over queries by
    ``attn_chunk`` as the reference's) and the SSM mixer the
    plain chunked scan (``ssm.ssm_forward``). The vlm family's frontend
    positions run through every layer and are dropped before the head,
    so the logits cover the token positions only."""
    x = _embed_inputs(model, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(model.layers):
        x, layer_aux = remat(cfg, _forward_layer, layer, x, cfg,
                             cfg.layer_kind(i)["global_attn"], positions)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x[:, cfg.frontend_positions:], cfg), aux


def init_decode_cache(cfg, batch: int, max_seq: int, device="cuda",
                      like=None):
    """Dense KV cache {"k", "v": (L, B, max_seq, K, Dh), "pos": 0}; for the
    SSM family the state slabs {"ssm_h": (L, B, H, P, N) fp32, "ssm_conv":
    (L, B, cw - 1, di + 2 N), "pos": 0}."""
    if cfg.family == "ssm":
        st = ssm_lib.init_ssm_state(cfg, batch, cfg.n_layers, device, like)
        return {"ssm_h": st["h"], "ssm_conv": st["conv"], "pos": 0}
    kv = attn.init_kv_cache(cfg, batch, max_seq, cfg.n_layers, device, like)
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
            x = constrain_batch(x + y)
            continue
        is_global = cfg.layer_kind(i)["global_attn"]
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.decode_attention(layer.attn, h, cache["k"][i],
                                      cache["v"][i], pos, cfg,
                                      is_global=is_global,
                                      windowed=windowed)
        x = constrain_batch(x + _ffn(layer, x, cfg)[0])
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
        x = constrain_batch(x + _ffn(layer, x, cfg)[0])
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


def decoder_verify_paged_chunk(model: Decoder, cache, tokens, page_table,
                               start, n_new, cfg, pages_bound=None,
                               window_start=0):
    """Speculative-verify chunk: the compute of the chunked paged prefill
    (the chunk's K/V land in the pool pages, every position attends
    causally to resident context + in-chunk keys; one paged prefill
    launch a layer) returning the post-norm hidden states (B, C, D) of
    EVERY chunk position. Row c scores the next token after position
    ``start + c`` (``ModelBundle.lm_head`` gives (B, C, V) logits): one
    launch a layer scores a γ-token draft chunk. Rows past ``n_new[b]``
    are PAD garbage the caller ignores.

    Only stacks that can roll a rejected suffix back verify
    (``PagedKVCache.truncate_slot``); recurrent state cannot, so the SSM
    family raises."""
    if cfg.family == "ssm":
        raise ValueError(f"{cfg.name}: recurrent state cannot roll back a "
                         "rejected draft suffix; ssm stacks do not verify")
    x = embed(model.embed, tokens)
    return _paged_chunk_attn_hidden(model, cache, x, page_table, start,
                                    n_new, cfg, pages_bound, window_start)


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
        x = constrain_batch(x + y)
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
            x = constrain_batch(x + y)
        x = rmsnorm(model.ln_f, x, cfg.norm_eps)
        return _unembed(model, x, cfg)[:, 0]
    for i, layer in enumerate(model.layers):
        w = cfg.layer_window(i)
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.paged_decode_attention(
            layer.attn, h, cache["k_pages"][i], cache["v_pages"][i],
            page_table, seq_lens, active, cfg, pages_bound, window=w,
            pages_start=window_start if w else 0)
        x = constrain_batch(x + _ffn(layer, x, cfg)[0])
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0]

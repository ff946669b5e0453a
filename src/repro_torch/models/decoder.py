"""Dense decoder-only LM: the dense-cache serving path and the paged
serving path of ``repro.models.decoder``.

The reference stacks layer weights on a leading axis and ``lax.scan``s
over them; here layers are a ``ModuleList`` and the scan is a Python loop,
so each layer's global/local flag is a static bool. Each layer reads and
writes its own slice ``cache[...][i]`` of the (L, B, max_seq, K, Dh) dense
cache or the (L, P, ps, K, Dh) page pools, which is contiguous, so the
kernels take it as it is. Only global-attention dense stacks are built so
far (``models.model.build_model`` refuses the rest); ``decoder_forward``
(training's teacher-forced forward) comes with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
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


class Decoder(nn.Module):
    """Parameter names follow the reference tree: ``embed.table``,
    ``layers.<i>.{ln1,attn,ln2,mlp}.*``, ``ln_f.scale`` and, untied,
    ``head.w``. Built empty on ``device``; fill with ``init_decoder`` or
    the bridge."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dt = dtype_of(cfg)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
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
    (>= S) so decode appends in place; ``cache["pos"]`` is S, a host
    int."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_seq = max(max_seq or S, S)
    cache = init_decode_cache(cfg, B, max_seq, tokens.device)
    x = embed(model.embed, tokens)
    positions = torch.arange(S, device=x.device)
    for i, layer in enumerate(model.layers):
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


def init_decode_cache(cfg, batch: int, max_seq: int, device="cuda"):
    """Dense KV cache {"k", "v": (L, B, max_seq, K, Dh), "pos": 0}."""
    kv = attn.init_kv_cache(cfg, batch, max_seq, cfg.n_layers, device)
    return {"k": kv["k"], "v": kv["v"], "pos": 0}


def decoder_decode_step(model: Decoder, cache, token, cfg, *,
                        windowed: bool = False):
    """One decode step. token: (B, 1) int. The new token's K/V land at
    ``cache["pos"]`` in every layer's slab IN PLACE, and ``cache["pos"]``
    advances; the same (updated) cache dict is returned. Returns
    (logits (B, V), cache)."""
    pos = cache["pos"]
    x = embed(model.embed, token)
    for i, layer in enumerate(model.layers):
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
    the serving engine's allocator, not in the cache."""
    if not cfg.supports_paged_kv:
        raise ValueError(f"{cfg.name}: no paged serving path "
                         f"({cfg.paged_unsupported_reason})")
    return attn.init_paged_kv_cache(cfg, num_pages, page_size, cfg.n_layers,
                                    device)


def _paged_chunk_attn_hidden(model: Decoder, cache, x, page_table, start,
                             n_new, cfg, pages_bound):
    """Run every layer over the embedded chunk ``x`` (B, C, D) — each
    writing the chunk's K/V into its pool pages and attending causally to
    resident context + in-chunk keys — then the final norm. Returns the
    post-norm hidden states (B, C, D) of every chunk position."""
    for i, layer in enumerate(model.layers):
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.paged_prefill_attention(
            layer.attn, h, cache["k_pages"][i], cache["v_pages"][i],
            page_table, start, n_new, cfg, pages_bound)
        x = x + mlp(layer.mlp, rmsnorm(layer.ln2, x, cfg.norm_eps))
    return rmsnorm(model.ln_f, x, cfg.norm_eps)


def decoder_prefill_paged_chunk(model: Decoder, cache, tokens, page_table,
                                start, n_new, cfg, pages_bound=None):
    """One chunked-prefill step over the paged pool (continuous batching).

    tokens: (B, C) int — a fixed-width chunk of prompt tokens per serving
    slot, PAD-filled past ``n_new[b]``; page_table (B, MP) int32 rows
    already cover positions ``start .. start + n_new - 1``. The pools in
    ``cache`` are updated in place. Returns x_last (B, 1, D), the
    final-norm hidden state of token ``start + n_new - 1``. The LM head is
    not applied here: only a prompt's final chunk needs logits, and the
    engine applies ``ModelBundle.lm_head`` to those alone."""
    B, C = tokens.shape
    x = embed(model.embed, tokens)
    x = _paged_chunk_attn_hidden(model, cache, x, page_table, start, n_new,
                                 cfg, pages_bound)
    last = torch.clamp(n_new.long() - 1, 0, C - 1)
    return x[torch.arange(B, device=x.device), last][:, None]


def decoder_decode_step_paged(model: Decoder, cache, token, page_table,
                              seq_lens, active, cfg, pages_bound=None):
    """One continuous-batching decode step over the serving slots.

    token: (B, 1) int — per-slot next token; page_table (B, MP) int32,
    seq_lens (B,) int32 and active (B,) bool come from the engine's page
    allocator; ``pages_bound`` is the engine's live page bound (None = the
    full table width). The pools in ``cache`` are updated in place.
    Returns logits (B, V)."""
    x = embed(model.embed, token)
    for i, layer in enumerate(model.layers):
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.paged_decode_attention(
            layer.attn, h, cache["k_pages"][i], cache["v_pages"][i],
            page_table, seq_lens, active, cfg, pages_bound)
        x = x + mlp(layer.mlp, rmsnorm(layer.ln2, x, cfg.norm_eps))
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0]

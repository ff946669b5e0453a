"""Whisper-style encoder-decoder backbone (arXiv:2212.04356; the port of
``repro.models.encdec``).

The conv+mel frontend is a stub (``models.frontends.audio_stub_embeds``):
the batch supplies precomputed frame embeddings ``enc_embeds`` (B, enc_seq,
d_model). The transformer backbone is fully implemented: encoder
self-attention (non-causal, no RoPE, learned absolute positions
``enc_pos``), and decoder layers of causal self-attention with RoPE,
cross-attention over the encoder output and a SwiGLU FFN, as the
reference adapts Whisper.

The reference scans over layers stacked on a leading axis; here
``enc_layers`` and ``dec_layers`` are ``ModuleList``s and the scans are
Python loops. On the card the encoder's self-attention runs the flash
kernel's non-causal mode, the decoder's self-attention the flash kernel
(prefill) and the dense decode kernel (decode), and decode
cross-attention the dense decode kernel over the layer's cross slab, read
in place with every key valid. Prefill cross-attention (queries and keys
differ in count) runs the plain masked softmax, as the reference runs it
outside any kernel. The dense cache holds the decoder's self K/V
(L, B, max_seq, K, Dh), each layer's cross K/V (L, B, enc_seq, K, Dh),
the all-valid (B, enc_seq) int8 vector the cross decode reads, and
``pos``, a host int; decode updates it in place. ``encdec_forward``
(training) launches no kernel: all three attentions are the plain
versions under autograd. ``cfg.remat`` checkpoints each encoder and
decoder layer of ``encdec_forward``, and the loops pin activations
batch-sharded where the reference does
(``sharding.context.constrain_batch``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.context import (cache_zeros, constrain_batch,
                                          write_seq)
from . import attention as attn
from .common import (MLP, Embedding, OutputHead, RMSNorm, dtype_of,
                     embed, empty_param, init_params_, mlp, remat, rmsnorm)
from .decoder import _unembed


class EncLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class DecLayer(nn.Module):
    """``ln1``, ``attn`` (self), ``ln_x``, ``cross``, ``ln2``, ``mlp``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg, device)
        self.ln_x = RMSNorm(cfg.d_model, dt, device)
        self.cross = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class EncDec(nn.Module):
    """Parameter names follow the reference tree: ``embed.table``,
    ``enc_pos`` (enc_seq, D), ``enc_layers.<i>.*`` (``EncLayer``),
    ``enc_ln_f.scale``, ``dec_layers.<i>.*`` (``DecLayer``),
    ``ln_f.scale`` and, untied, ``head.w``. Built empty on ``device``;
    fill with ``init_encdec`` or the bridge."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dt = dtype_of(cfg)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dt, device)
        self.enc_pos = empty_param((cfg.enc_seq, cfg.d_model), dt, device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_ln_f = RMSNorm(cfg.d_model, dt, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.head = OutputHead(cfg.d_model, cfg.padded_vocab, dt, device)


def init_encdec(cfg, generator, device="cuda") -> EncDec:
    """An encoder-decoder with weights drawn from the reference's init
    distributions through ``generator`` (on ``device``)."""
    return init_params_(EncDec(cfg, device), generator)


def _encode(model: EncDec, enc_embeds, cfg, attend):
    x = enc_embeds.to(dtype_of(cfg)) + model.enc_pos[None,
                                                     :enc_embeds.shape[1]]
    for layer in model.enc_layers:
        x = remat(cfg, _enc_layer, layer, x, cfg, attend)
    return rmsnorm(model.enc_ln_f, x, cfg.norm_eps)


def _enc_layer(layer: EncLayer, x, cfg, attend):
    h = rmsnorm(layer.ln1, x, cfg.norm_eps)
    x = x + attend(layer.attn, h, cfg, causal=False, use_rope=False)
    return constrain_batch(x + mlp(layer.mlp,
                                   rmsnorm(layer.ln2, x, cfg.norm_eps)))


def encode(model: EncDec, enc_embeds, cfg):
    """enc_embeds: (B, enc_seq, D) stub frontend output. Returns the
    encoder output (B, enc_seq, D); each layer's self-attention is one
    flash launch (non-causal) on the card."""
    return _encode(model, enc_embeds, cfg, attn.attention_forward)


def _cross_kv(layer: DecLayer, enc_out, cfg):
    """A decoder layer's cross K/V over the encoder output, each
    (B, enc_seq, K, Dh), projected without bias as the reference does."""
    return attn._proj(enc_out, layer.cross.wk), \
        attn._proj(enc_out, layer.cross.wv)


def _dec_layer(layer: DecLayer, x, enc_out, cfg, positions):
    """One decoder layer of the teacher-forced pass."""
    h = rmsnorm(layer.ln1, x, cfg.norm_eps)
    x = x + attn.training_attention(layer.attn, h, cfg, positions=positions)
    h = rmsnorm(layer.ln_x, x, cfg.norm_eps)
    x = x + attn.training_attention(
        layer.cross, h, cfg, causal=False, use_rope=False,
        kv_override=_cross_kv(layer, enc_out, cfg))
    return constrain_batch(x + mlp(layer.mlp,
                                   rmsnorm(layer.ln2, x, cfg.norm_eps)))


def encdec_forward(model: EncDec, batch: dict, cfg):
    """Teacher-forced forward. batch: {"enc_embeds" (B, enc_seq, D),
    "tokens" (B, S)}. Returns (logits (B, S, V) over the padded vocab, tail
    masked; aux, a 0-d fp32 zero). Differentiable, and no kernel launches:
    all three attentions run ``attention.training_attention``."""
    enc_out = _encode(model, batch["enc_embeds"], cfg,
                      attn.training_attention)
    x = embed(model.embed, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in model.dec_layers:
        x = remat(cfg, _dec_layer, layer, x, enc_out, cfg, positions)
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def encdec_prefill(model: EncDec, batch: dict, cfg, max_seq=None):
    """Encode once, run the decoder prompt ``batch["tokens"]`` (B, S),
    cache the self K/V (slabs sized ``max_seq`` >= S, so decode appends in
    place) and each layer's cross K/V. Returns (last-token logits (B, V),
    cache); ``cache["pos"]`` is S, a host int."""
    enc_out = encode(model, batch["enc_embeds"], cfg)
    x = embed(model.embed, batch["tokens"])
    B, S = x.shape[:2]
    max_seq = max(max_seq or S, S)
    cache = init_encdec_cache(cfg, B, max_seq, x.device, like=x)
    positions = torch.arange(S, device=x.device)
    for i, layer in enumerate(model.dec_layers):
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        o, (k, v) = attn.prefill_attention(layer.attn, h, cfg,
                                           positions=positions)
        write_seq(cache["k"][i], 0, k)
        write_seq(cache["v"][i], 0, v)
        x = x + o
        h = rmsnorm(layer.ln_x, x, cfg.norm_eps)
        ck, cv = _cross_kv(layer, enc_out, cfg)
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
        x = x + attn.attention_forward(layer.cross, h, cfg, causal=False,
                                       kv_override=(ck, cv), use_rope=False)
        x = constrain_batch(x + mlp(layer.mlp,
                                    rmsnorm(layer.ln2, x, cfg.norm_eps)))
    cache["pos"] = S
    x = rmsnorm(model.ln_f, x[:, -1:], cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0], cache


def init_encdec_cache(cfg, batch: int, max_seq: int, device="cuda",
                      like=None):
    """{"k", "v": (L, B, max_seq, K, Dh), "cross_k", "cross_v":
    (L, B, enc_seq, K, Dh), zero-filled; "cross_valid": (B, enc_seq) int8
    ones; "pos": 0}."""
    K, Dh, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    dt = dtype_of(cfg)
    kv = attn.init_kv_cache(cfg, batch, max_seq, L, device, like)
    cross = (L, batch, cfg.enc_seq, K, Dh)
    return {"k": kv["k"], "v": kv["v"],
            "cross_k": cache_zeros("cross_k", cross, dt, device, batch, like),
            "cross_v": cache_zeros("cross_v", cross, dt, device, batch, like),
            "cross_valid": torch.ones((batch, cfg.enc_seq), dtype=torch.int8,
                                      device=device),
            "pos": 0}


def encdec_decode_step(model: EncDec, cache, token, cfg, *,
                       windowed: bool = False):
    """One decode step. token: (B, 1) int. The new token's self K/V land
    at ``cache["pos"]`` in every layer's slab IN PLACE and
    ``cache["pos"]`` advances; the cross slabs are read only. ``windowed``:
    the long-context mode of the self-attention
    (``attention.decode_attention``). Returns (logits (B, V), cache)."""
    pos = cache["pos"]
    x = embed(model.embed, token)
    for i, layer in enumerate(model.dec_layers):
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        x = x + attn.decode_attention(layer.attn, h, cache["k"][i],
                                      cache["v"][i], pos, cfg,
                                      windowed=windowed)
        h = rmsnorm(layer.ln_x, x, cfg.norm_eps)
        x = x + attn.decode_cross_attention(
            layer.cross, h, cache["cross_k"][i], cache["cross_v"][i], cfg,
            cache["cross_valid"])
        x = constrain_batch(x + mlp(layer.mlp,
                                    rmsnorm(layer.ln2, x, cfg.norm_eps)))
    cache["pos"] = pos + 1
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    return _unembed(model, x, cfg)[:, 0], cache

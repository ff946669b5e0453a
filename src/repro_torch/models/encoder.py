"""BERT-style bidirectional encoder — the router backbone (paper §3), the
port of ``repro.models.encoder``.

The paper uses DeBERTa-v3-large (300M). Like the reference, this is a
BERT-class encoder with T5-style relative-position attention bias, mean
pooling over non-pad tokens and a 2-layer scoring head producing one
logit; ``sigmoid(logit) = p_w(x) ∈ [0, 1]``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .common import MLP, RMSNorm, empty_param, init_params_, mlp, rmsnorm


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    vocab_size: int
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    max_seq: int = 256
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _relative_bucket(rel: torch.Tensor, n_buckets: int,
                     max_dist: int) -> torch.Tensor:
    """T5 symmetric relative position bucketing, in fp32 like the
    reference (the log ratio truncates to an int bucket)."""
    n = n_buckets // 2
    ret = torch.where(rel > 0, n, 0)
    rel = rel.abs()
    max_exact = n // 2
    is_small = rel < max_exact
    denom = torch.log(torch.tensor(max_dist / max_exact, dtype=torch.float32,
                                   device=rel.device))
    log_ratio = torch.log(rel.float() / max_exact + 1e-6) / denom
    large = max_exact + (log_ratio * (n - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=n - 1)
    return ret + torch.where(is_small, rel, large)


class RouterLayer(nn.Module):
    def __init__(self, cfg: RouterConfig, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        self.ln1 = RMSNorm(D, dtype, device)
        self.wqkv = empty_param((D, 3, cfg.n_heads, cfg.head_dim), dtype, device)
        self.wo = empty_param((D, D), dtype, device)
        self.ln2 = RMSNorm(D, dtype, device)
        self.mlp = MLP(D, cfg.d_ff, dtype, device)


class RouterEncoder(nn.Module):
    """Parameter names follow the reference tree: ``embed``, ``rel_bias``,
    ``layers.<i>.{ln1,wqkv,wo,ln2,mlp}``, ``ln_f.scale``, ``head_w1``,
    ``head_w2``. Built empty; fill with ``init_router_encoder`` or the
    bridge."""

    def __init__(self, cfg: RouterConfig, device="cuda"):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        D = cfg.d_model
        self.embed = empty_param((cfg.vocab_size, D), dt, device)
        self.rel_bias = empty_param((cfg.rel_buckets, cfg.n_heads), dt, device)
        self.layers = nn.ModuleList(RouterLayer(cfg, dt, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(D, dt, device)
        self.head_w1 = empty_param((D, D), dt, device)
        self.head_w2 = empty_param((D, 1), dt, device)


def init_router_encoder(cfg: RouterConfig, generator,
                        device="cuda") -> RouterEncoder:
    """A router with weights drawn from the reference's init distributions
    through ``generator`` (on ``device``)."""
    return init_params_(RouterEncoder(cfg, device), generator)


def router_encode(model: RouterEncoder, tokens, mask,
                  cfg: RouterConfig) -> torch.Tensor:
    """tokens: (B, S) int; mask: (B, S) 1=real token. Returns logits (B,)
    in fp32."""
    B, S = tokens.shape
    x = model.embed[tokens]
    pos = torch.arange(S, device=x.device)
    rel = pos[None, :] - pos[:, None]
    buckets = _relative_bucket(rel, cfg.rel_buckets, cfg.rel_max_distance)
    bias = model.rel_bias[buckets].permute(2, 0, 1)[None].float()  # (1,H,S,S)
    attn_mask = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30)
    scale = cfg.head_dim ** -0.5
    H, hd = cfg.n_heads, cfg.head_dim
    for layer in model.layers:
        h = rmsnorm(layer.ln1, x, cfg.norm_eps)
        qkv = (h @ layer.wqkv.reshape(cfg.d_model, 3 * H * hd)
               ).reshape(B, S, 3, H, hd)
        q, k, v = qkv.unbind(dim=2)
        scores = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
        scores = scores + bias + attn_mask
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.einsum("bhqs,bshk->bqhk", w, v).reshape(B, S, cfg.d_model)
        x = x + o @ layer.wo
        h = rmsnorm(layer.ln2, x, cfg.norm_eps)
        x = x + mlp(layer.mlp, h)
    x = rmsnorm(model.ln_f, x, cfg.norm_eps)
    m = mask.to(x.dtype)
    denom = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    pooled = (x * m[..., None]).sum(1) / denom
    h = torch.tanh(pooled @ model.head_w1)
    return (h @ model.head_w2)[:, 0].float()

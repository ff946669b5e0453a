"""Common layers: parameter containers, norms, RoPE, MLP, embeddings, the
init helpers and the LM loss (the port of ``repro.models.common``).

Parameters keep the reference's names and layouts, so that the weight
bridge (``repro_torch.bridge``) is a copy key for key. Modules are built
empty (``torch.empty`` on the target device) and filled either by the
bridge or by ``init_params_``, which draws from the reference's
distributions through a ``torch.Generator`` (the same distributions, not
the same numbers: JAX and PyTorch streams differ).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------- init
_TRUNC = 2.0   # truncation bound, in standard deviations


def trunc_normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Fill ``t`` with N(0, std^2) truncated to +-2 std (the reference's
    ``jax.random.truncated_normal(key, -2, 2) * std``), by inverse-CDF
    sampling on ``t``'s device."""
    cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    lo, hi = 2.0 * cdf(-_TRUNC) - 1.0, 2.0 * cdf(_TRUNC) - 1.0
    t.uniform_(lo, hi, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-_TRUNC * std, _TRUNC * std)
    return t


@torch.no_grad()
def init_params_(module: nn.Module, generator) -> nn.Module:
    """Fill every parameter of ``module`` from the reference's init
    distributions, by name: norm ``scale`` ones, QKV biases zeros, token
    embedding tables truncated normal * 0.02 (``embed_init``), the router's
    ``rel_bias`` normal * 0.02; the SSM mixer's ``conv_w`` truncated normal
    * 0.2, ``A_log`` log(linspace(1, 16, H)), ``D`` ones and ``dt_bias``
    log(expm1(linspace(1e-3, 1e-1, H))) (``models/ssm.py::init_ssm``);
    every other weight truncated normal over its fan-in, the leading axis
    (``dense_init``)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "D"):
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            p.zero_()
        elif leaf in ("table", "embed"):
            trunc_normal_(p, 0.02, generator)
        elif leaf == "rel_bias":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "conv_w":
            trunc_normal_(p, 0.2, generator)
        elif leaf == "A_log":
            p.copy_(torch.linspace(1.0, 16.0, len(p)).log())
        elif leaf == "dt_bias":
            p.copy_(torch.linspace(1e-3, 1e-1, len(p)).expm1().log())
        else:
            trunc_normal_(p, 1.0 / math.sqrt(p.shape[0]), generator)
    return module


# --------------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.scale = empty_param((dim,), dtype, device)


def rmsnorm(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * norm.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs           # (B, S, d/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """SwiGLU MLP weights: w_in, w_gate (D, F) and w_out (F, D)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.w_in = empty_param((d_model, d_ff), dtype, device)
        self.w_gate = empty_param((d_model, d_ff), dtype, device)
        self.w_out = empty_param((d_ff, d_model), dtype, device)


def mlp(m: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    return (F.silu(x @ m.w_gate) * (x @ m.w_in)) @ m.w_out


# ---------------------------------------------------------------- embeddings
class Embedding(nn.Module):
    """Token embedding ``table`` (padded_vocab, D)."""

    def __init__(self, vocab: int, dim: int, dtype, device=None):
        super().__init__()
        self.table = empty_param((vocab, dim), dtype, device)


def embed(emb: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return emb.table[tokens]


def _mask_padded_vocab(logits: torch.Tensor, logical_vocab: int):
    """Padded vocab tail -> the dtype's most negative finite value, as the
    reference masks it: a softmax over the padded width (``softmax_xent``)
    gives the tail zero mass and zero gradient."""
    padded = logits.shape[-1]
    if padded != logical_vocab:
        logits[..., logical_vocab:] = torch.finfo(logits.dtype).min
    return logits


def unembed(emb: Embedding, x: torch.Tensor, logical_vocab: int):
    """Tied head: project to (padded) vocab logits, padded tail masked."""
    return _mask_padded_vocab(x @ emb.table.T.to(x.dtype), logical_vocab)


class OutputHead(nn.Module):
    """Untied LM head ``w`` (D, padded_vocab)."""

    def __init__(self, d_model: int, vocab: int, dtype, device=None):
        super().__init__()
        self.w = empty_param((d_model, vocab), dtype, device)


def output_head(head: OutputHead, x: torch.Tensor, logical_vocab: int):
    return _mask_padded_vocab(x @ head.w, logical_vocab)


# -------------------------------------------------------------------- losses
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy, in fp32. logits (..., V), labels (...)
    int; ``mask`` (...) weights each position (1 = counted)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

"""Top-k routed mixture-of-experts FFN (the port of ``repro.models.moe``):
GShard-style dispatch with one group per batch row and a per-group
capacity, and the Switch load-balance aux loss.

The routing is the reference's to the bit: fp32 gate logits, softmax,
top-k, the top-k weights renormalised by ``max(sum, 1e-9)``; in each row
the T·k assignments are sorted stably by expert id, an assignment's rank
is its place in its expert's segment (``searchsorted``, left side), and an
assignment ranked at or past the capacity C is dropped.

The compute differs from the reference's, not the function. The
reference scatters every row's kept assignments into an (E, C, D) buffer,
with C rounded up to a multiple of 128 for the TPU's matrix unit, and
multiplies the whole buffer; a 16-token prefill chunk at top-2 fills 32
of a row's E·C rows. The combine never reads an empty slot, so here each
expert multiplies only its kept assignments, gathered from every row of
the batch, with ``torch.matmul``: the expert products are einsums in the
reference too, outside any Pallas kernel. Each assignment's output lands
in its own row of a (B·T·k, D) buffer (a dropped one stays zero), which
is weighed by the top-k weights and summed over k, as the reference's
combine does. That costs one host sync a layer: the experts' kept counts
size the per-expert products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dtype_of, empty_param


class MoE(nn.Module):
    """Weights in the reference's layouts: ``w_gate_logits`` (D, E), and
    each expert's SwiGLU ``w_in``, ``w_glu`` (E, D, F) and ``w_out``
    (E, F, D)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = dtype_of(cfg)
        self.w_gate_logits = empty_param((D, E), dt, device)
        self.w_in = empty_param((E, D, Fd), dt, device)
        self.w_glu = empty_param((E, D, Fd), dt, device)
        self.w_out = empty_param((E, Fd, D), dt, device)


def capacity_of(group_tokens: int, cfg) -> int:
    """Per-expert capacity of a dispatch group of ``group_tokens`` tokens,
    as the reference computes it (rounded up to a multiple of 128)."""
    c = int(cfg.top_k * group_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 127) // 128) * 128)


def route(moe: MoE, x, cfg):
    """The gate and the dispatch of ``x`` (B, S, D), one group a row.
    Returns (top_w (B, S, k) renormalised, top_i (B, S, k), keep (B, S·k)
    bool in assignment order (token-major, then k), aux 0-d fp32)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    A = S * k
    C = capacity_of(S, cfg)
    probs = torch.softmax((x @ moe.w_gate_logits).float(), dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)               # (B, S, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum(mean prob * fraction routed first)
    ce = F.one_hot(top_i[..., 0], E).float().mean((0, 1))
    aux = E * torch.sum(probs.mean((0, 1)) * ce)
    eid = top_i.reshape(B, A)
    order = torch.argsort(eid, dim=1, stable=True)
    sorted_e = torch.gather(eid, 1, order)
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    rank = torch.arange(A, device=x.device) - torch.gather(seg_start, 1,
                                                           sorted_e)
    keep = torch.zeros_like(rank, dtype=torch.bool).scatter_(1, order,
                                                             rank < C)
    return top_w, top_i, keep, aux


def moe_forward(moe: MoE, x, cfg):
    """x: (B, S, D) -> (y (B, S, D), aux 0-d fp32). Differentiable."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    top_w, top_i, keep, aux = route(moe, x, cfg)
    # the kept assignments grouped by expert (a stable sort keeps each
    # expert's rows in batch order); a dropped one sorts past the last
    key = torch.where(keep, top_i.reshape(B, S * k), E).reshape(-1)
    counts = torch.bincount(key, minlength=E + 1)[:E].tolist()
    idx = torch.argsort(key, stable=True)[:sum(counts)]
    rows = x.reshape(B * S, D)[idx // k]
    out = x.new_zeros((B * S * k, D))
    lo = 0
    for e, n in enumerate(counts):
        if n:
            xe = rows[lo:lo + n]
            h = F.silu(xe @ moe.w_glu[e]) * (xe @ moe.w_in[e])
            out[idx[lo:lo + n]] = h @ moe.w_out[e]
        lo += n
    y = (out.reshape(B, S, k, D) * top_w[..., None].to(out.dtype)).sum(2)
    return y, aux


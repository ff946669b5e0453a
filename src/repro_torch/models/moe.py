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

On a launcher's mesh (``x`` a DTensor), and wherever the caller enters
``capacity_dispatch()`` (the dry run does, on its fake tensors, which
have no values to count), the layer is the reference's compute instead,
which has no host sync: every row's kept assignments scattered into an
(E, C, D) buffer, the expert products over the whole buffer, and the
combine. The dispatch and the combine are group-local, one group a batch
row, so each rank runs them on its own rows in plain PyTorch (the
reference's "local to the data shard under SPMD"); DTensor shards the
expert products. Both computes share the gate and the slot ranks
(``_gate``, ``_ranks``) with ``route``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.context import sequence_scatter
from repro_torch.sharding.layers import from_rows, rows_of
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


def _gate(moe: MoE, x, cfg):
    """The gate of ``x`` (B, S, D): (top_w (B, S, k) renormalised, top_i
    (B, S, k), the Switch aux loss 0-d fp32)."""
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax((x @ moe.w_gate_logits).float(), dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)               # (B, S, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum(mean prob * fraction routed first)
    ce = F.one_hot(top_i[..., 0], E).float().mean((0, 1))
    aux = E * torch.sum(probs.mean((0, 1)) * ce)
    return top_w, top_i, aux


def _ranks(eid, E: int):
    """Each row's assignments ``eid`` (b, A) sorted stably by expert:
    (order (b, A), the sorted experts, each sorted assignment's rank in
    its expert's segment)."""
    A = eid.shape[1]
    order = torch.argsort(eid, dim=1, stable=True)
    sorted_e = torch.gather(eid, 1, order)
    experts = torch.arange(E, device=eid.device).expand(eid.shape[0], E)
    seg_start = torch.searchsorted(sorted_e, experts.contiguous(),
                                   side="left")
    rank = torch.arange(A, device=eid.device) - torch.gather(seg_start, 1,
                                                             sorted_e)
    return order, sorted_e, rank


def route(moe: MoE, x, cfg):
    """The gate and the dispatch of ``x`` (B, S, D), one group a row.
    Returns (top_w (B, S, k) renormalised, top_i (B, S, k), keep (B, S·k)
    bool in assignment order (token-major, then k), aux 0-d fp32)."""
    B, S, _ = x.shape
    top_w, top_i, aux = _gate(moe, x, cfg)
    order, _, rank = _ranks(top_i.reshape(B, S * cfg.top_k), cfg.n_experts)
    keep = torch.zeros_like(rank, dtype=torch.bool).scatter_(
        1, order, rank < capacity_of(S, cfg))
    return top_w, top_i, keep, aux


_CAPACITY = contextvars.ContextVar("moe_capacity_dispatch", default=False)


@contextlib.contextmanager
def capacity_dispatch():
    """Run every MoE layer as the reference's capacity-buffer compute
    (``_moe_capacity``) on any device, as the dry run does on its fake
    tensors: the per-expert compute sizes its products by the experts'
    counts, which a fake tensor does not hold."""
    token = _CAPACITY.set(True)
    try:
        yield
    finally:
        _CAPACITY.reset(token)


def moe_forward(moe: MoE, x, cfg):
    """x: (B, S, D) -> (y (B, S, D), aux 0-d fp32). Differentiable."""
    if _CAPACITY.get() or hasattr(x, "device_mesh"):
        return _moe_capacity(moe, x, cfg)
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


def _moe_capacity(moe: MoE, x, cfg):
    """The reference's GShard compute, on DTensors or plain tensors (the
    dry run's fake ones): (y, aux)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    A, C = S * k, capacity_of(S, cfg)
    top_w, top_i, aux = _gate(moe, x, cfg)
    # dispatch, each rank over its own rows
    xl, where = rows_of(x, 2)
    order, sorted_e, rank = _ranks(rows_of(top_i, 2)[0].reshape(-1, A), E)
    b = order.shape[0]
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)      # E*C: dropped
    rows = torch.gather(xl, 1, (order // k)[..., None].expand(-1, -1, D))
    buf = xl.new_zeros((b, E * C + 1, D)).scatter(
        1, slot[..., None].expand(-1, -1, D), rows)
    buf = from_rows(buf[:, :-1].reshape(b, E, C, D), where)
    act = F.silu(torch.einsum("becd,edf->becf", buf, moe.w_glu)) \
        * torch.einsum("becd,edf->becf", buf, moe.w_in)
    out = torch.einsum("becf,efd->becd", act.contiguous(), moe.w_out)
    # combine, each rank over its own rows
    ol = rows_of(out, 3)[0].reshape(b, E * C, D)
    ol = torch.cat([ol, ol.new_zeros((b, 1, D))], 1)
    per = torch.gather(ol, 1, slot[..., None].expand(-1, -1, D)) \
        * keep[..., None].to(ol.dtype)
    unsorted = torch.zeros_like(per).scatter(
        1, order[..., None].expand(-1, -1, D), per)
    twl = rows_of(top_w, 2)[0]
    y = (unsorted.reshape(b, S, k, D) * twl[..., None].to(ol.dtype)).sum(2)
    return sequence_scatter(from_rows(y, where)), aux

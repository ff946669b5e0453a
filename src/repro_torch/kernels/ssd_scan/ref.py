"""Plain PyTorch versions of the SSD intra-chunk kernel.

``ssd_chunk_ref`` mirrors ``repro/kernels/ssd_scan/ref.py`` in the
kernel's flattened layout; ``ssd_chunk_reference`` mirrors the model-layout
oracle ``repro/models/ssm.py::ssd_chunk_reference``. Both hold the whole
(l, l) decay matrix, masked with ``where`` so that the overflowing
``exp(dA_i - dA_j)`` above the diagonal is never multiplied in. They are
the CPU path of ``ops`` and the yardstick the CUDA kernel is held against
on the card.
"""
from __future__ import annotations

import torch


def _decay(da: torch.Tensor, axis: int) -> torch.Tensor:
    """exp(da_i - da_j) for j <= i, else 0, over the chunk axis ``axis``
    of ``da``: the (i, j) pair is inserted at ``axis``, ``axis + 1``."""
    l = da.shape[axis]
    rel = da.unsqueeze(axis + 1) - da.unsqueeze(axis)
    mask = torch.ones((l, l), dtype=torch.bool, device=da.device).tril()
    mask = mask.reshape((1,) * axis + (l, l) + (1,) * (rel.ndim - axis - 2))
    return torch.where(mask, torch.exp(rel), 0.0)


def ssd_chunk_ref(x, dt, dacum, B, C):
    """x: (BC, H, l, P); dt, dacum: (BC, H, l, 1); B, C: (BC, l, N).
    Returns (y (BC, H, l, P) fp32, states (BC, H, N, P) fp32)."""
    x = x.float()
    dt = dt[..., 0].float()                               # (BC, H, l)
    da = dacum[..., 0].float()
    Bf, Cf = B.float(), C.float()
    decay = _decay(da, 2)                                 # (BC, H, i, j)
    scores = torch.einsum("bin,bjn->bij", Cf, Bf)         # (BC, i, j)
    gated = scores[:, None] * decay * dt[..., None, :]
    y = torch.einsum("bhij,bhjp->bhip", gated, x)
    w = torch.exp(da[..., -1:] - da) * dt                 # (BC, H, l)
    st = torch.einsum("bhl,bln,bhlp->bhnp", w, Bf, x)
    return y, st


def ssd_chunk_reference(xs, dts, dA_cum, Bs, Cs):
    """Model layout: xs (b, nc, l, H, P); dts, dA_cum (b, nc, l, H);
    Bs, Cs (b, nc, l, N). Returns y_diag (b, nc, l, H, P) fp32 and states
    (b, nc, H, P, N) fp32."""
    decay = _decay(dA_cum, 2)                             # (b, nc, i, j, H)
    scores = torch.einsum("bcin,bcjn->bcij", Cs.float(), Bs.float())
    gated = scores[..., None] * decay * dts[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", gated, xs.float())
    w = torch.exp(dA_cum[:, :, -1:, :] - dA_cum) * dts    # (b, nc, l, H)
    states = torch.einsum("bclh,bcln,bclhp->bchpn", w, Bs.float(),
                          xs.float())
    return y_diag, states

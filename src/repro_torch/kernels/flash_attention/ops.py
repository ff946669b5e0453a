"""Wrappers of the flash-attention (prefill) kernel.

The tensor's device decides the path: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the hand-written kernel
``csrc/flash_attention.cu`` or raise. There is no fallback between the
two. The kernel takes fp32 (3xTF32 products) or bf16 (its own design:
native bf16 ``mma.sync`` m16n8k16 products on bf16 tiles, exact on bf16
values and on P rounded to bf16): q, k, v and the output of one dtype, the
entry ``flash_attention_f32`` or ``_bf16`` by q's dtype, accumulating in
fp32 either way; anything else raises. ``flash_attention.launches`` counts
kernel launches of both wrappers, and ``.launches_by_dtype`` splits them
by dtype.
"""
from __future__ import annotations

import torch

from ..common import ENTRY_SUFFIX, check_inputs, count_launch, launch
from .ref import attention_ref

MAX_HEAD_DIM = 256   # a block's shared memory then stays under 200 KB


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model layout: q (B, S, H, D) pre-scaled; k, v (B, S, K, D) with
    ``H % K == 0``, query head h reading kv head ``h // (H // K)`` (the
    reference expands kv to H heads first; the values are the same).
    ``window``: sliding-window size (0 = none). Returns (B, S, H, D)
    contiguous. On the card q, k and v are read through their strides
    (unit stride on D), so views of a projection need no copy."""
    B, S, H, D = q.shape
    K = k.shape[2]
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"window={window}")
    if q.device.type == "cpu":
        kx = k.repeat_interleave(H // K, dim=2)
        vx = v.repeat_interleave(H // K, dim=2)
        bhsd = lambda t: t.movedim(2, 1).reshape(B * H, S, D)
        out = attention_ref(bhsd(q), bhsd(kx), bhsd(vx), causal=causal,
                            window=window)
        return out.reshape(B, H, S, D).movedim(1, 2)
    dtype = check_inputs("flash_attention", {"q": q, "k": k, "v": v}, {},
                         strided=("q", "k", "v"))
    if v.stride() != k.stride():
        raise ValueError("flash_attention: k and v must share strides")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel():
        launch("flash_attention", f"flash_attention_{ENTRY_SUFFIX[dtype]}",
               q, k, v, out, B, S, H, K, D, int(causal), window,
               *q.stride()[:3], *k.stride()[:3])
        count_launch(flash_attention, dtype)
    return out


flash_attention.launches = 0
flash_attention.launches_by_dtype = {}


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """The TPU kernel's contract: q, k, v (BH, S, D), q pre-scaled. Returns
    (BH, S, D). The same kernel as ``flash_attention`` with one head."""
    return flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                           causal=causal, window=window)[:, :, 0]

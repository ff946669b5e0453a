"""Wrappers of the dense-cache GQA decode-attention kernel.

Three entries, as in ``repro/kernels/decode_attention/ops.py`` plus the
kernel's own contract; all three are one kernel launch:

  decode_attention_kv  q (B, H, D), raw cache k, v (B, S, K, D), valid
                       (B, S) — the production layout the model calls
  decode_attention     q (B, 1, H, D), head-expanded k, v (B, S, H, D),
                       valid (S,) or (B, S)
  decode_attention_gqa the TPU kernel's (BK, G, D), (BK, S, D), (BK, S)

The tensor's device decides the path: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the hand-written kernel
``csrc/decode_attention.cu`` or raise. There is no fallback between the
two. The kernel takes fp32 or bf16 (q, k, v and the output of one dtype;
the entry ``decode_attention_f32`` or ``_bf16`` by q's dtype),
accumulating in fp32 either way; anything else raises.
``decode_attention_kv.launches`` counts kernel launches of all three, and
``.launches_by_dtype`` splits them by dtype.
"""
from __future__ import annotations

import torch

from ..common import (ENTRY_SUFFIX, check_inputs, count_launch, launch,
                      query)
from .ref import decode_attention_ref

MAX_HEAD_DIM = 256   # 8 columns a lane
NAME = "decode_attention"


def decode_attention_kv(q, k, v, valid):
    """q: (B, H, D) pre-scaled; k, v: (B, S, K, D) raw cache with
    ``H % K == 0``; valid: (B, S), a key counts where ``valid > 0``.
    Returns (B, H, D) contiguous. On the card k and v are read in place
    through their strides (unit stride on D): a layer's slice of the dense
    cache needs no head-major copy."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if valid.shape != (B, S):
        raise ValueError(f"valid {tuple(valid.shape)} is not {(B, S)}")
    G = H // K
    if q.device.type == "cpu":
        qg = q.reshape(B * K, G, D)
        kg = k.movedim(2, 1).reshape(B * K, S, D)
        vg = v.movedim(2, 1).reshape(B * K, S, D)
        vmask = valid.repeat_interleave(K, dim=0).to(torch.int8)
        return decode_attention_ref(qg, kg, vg, vmask).reshape(B, H, D)
    dtype = check_inputs(NAME, {"q": q, "k": k, "v": v}, {"valid": valid},
                         strided=("k", "v"), int_dtype=torch.int8)
    if v.stride() != k.stride():
        raise ValueError("decode_attention: k and v must share strides")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    if out.numel():
        # each split's partial (m, l, accumulator) and the counts of
        # finished splits, where S spans more than one split: the kernel's
        # source says how much, and the launch zeroes the counts on its
        # stream
        n = query(NAME, "decode_attention_workspace_bytes", B, S, K, G, D)
        ws = torch.empty(n, dtype=torch.uint8, device=q.device) if n else out
        launch(NAME, f"{NAME}_{ENTRY_SUFFIX[dtype]}", q, k, v, valid, out,
               ws, B, S, K, G, D, *k.stride()[:3])
        count_launch(decode_attention_kv, dtype)
    return out


decode_attention_kv.launches = 0
decode_attention_kv.launches_by_dtype = {}


def decode_attention(q, k_exp, v_exp, valid):
    """q: (B, 1, H, D) pre-scaled; k_exp, v_exp: (B, S, H, D) head-expanded
    cache; valid: (S,) or (B, S). Returns (B, 1, H, D)."""
    B, S = k_exp.shape[:2]
    if valid.dim() == 1:
        valid = valid[None].expand(B, S)
    return decode_attention_kv(q[:, 0], k_exp, v_exp,
                               valid.to(torch.int8).contiguous())[:, None]


def decode_attention_gqa(q, k, v, valid):
    """The TPU kernel's contract: q (BK, G, D) pre-scaled; k, v (BK, S, D);
    valid (BK, S) int8. Returns (BK, G, D)."""
    return decode_attention_kv(q, k[:, :, None], v[:, :, None], valid)

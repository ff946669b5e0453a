"""Wrappers of the SSD intra-chunk kernel.

The tensor's device decides the path: CPU tensors take the plain versions
(``ref.py``); CUDA tensors launch the hand-written kernel
``csrc/ssd_scan.cu`` or raise. There is no fallback between the two.
Both entries are one launch, and ``ssd_chunk_scan.launches`` counts the
launches of both (``ssd_chunk_scan.launches_by_dtype`` by x's dtype).
x, B and C are fp32 or bf16, one dtype for the three (its C entry,
``ssd_chunk_scan_f32`` or ``ssd_chunk_scan_bf16``); dt and dA are fp32
in both, as the reference's model passes them; y and the state come out
fp32 in both, as the TPU kernel writes them. Anything else (fp16, a mix
across x, B and C, a bf16 dt or dA) raises before a launch. The kernel
multiplies on the tensor cores: 3xTF32 at fp32, which keeps fp32
accuracy; at bf16 native bf16 products, one for the scores and two bf16
parts of each fp32 gate for y and the state, which keep the kernel's
tolerance (1e-4 of the outputs' scale) but not fp32 accuracy. It sums
every output in an order fixed by absolute position, so a chunk's
outputs do not depend on how many chunks share the launch.
"""
from __future__ import annotations

import torch

from ..common import (ENTRY_SUFFIX, check_inputs, count_launch, float_dtype,
                      launch)
from .ref import ssd_chunk_ref, ssd_chunk_reference

MAX_HEAD_DIM = 128   # P: output columns a warp keeps in registers
MAX_STATE = 256      # N: a block's shared memory then stays under 200 KB
MAX_GRID_Y = 65535   # head groups are a grid dimension


def _launch(x, dt, da, B, C, y, st, shape, x_s, d_s, b_s, y_s, s_s):
    """One launch over ``shape`` = (BC, H, l, P, N), BC = batch*chunks.
    ``x_s``: x's element strides over (bc, head, position), unit stride on
    P; ``d_s``: the same for dt and dA; ``b_s``: B's and C's over
    (bc, position), unit stride on N; ``y_s``: y's over (bc, head,
    position); ``s_s``: the state's over (bc, head, n, p)."""
    BC, H, l, P, N = shape
    if not 1 <= P <= MAX_HEAD_DIM or not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd_chunk_scan: P={P} outside [1, "
                         f"{MAX_HEAD_DIM}] or N={N} outside [1, {MAX_STATE}]")
    if H > MAX_GRID_Y:
        raise ValueError(f"ssd_chunk_scan: {H} heads exceed the grid's "
                         f"{MAX_GRID_Y}")
    if BC * H * l == 0:
        return
    launch("ssd_scan", f"ssd_chunk_scan_{ENTRY_SUFFIX[x.dtype]}", x, dt, da,
           B, C, y, st, BC, H, l, P, N, *x_s, *d_s, *b_s, *y_s, *s_s)
    count_launch(ssd_chunk_scan, x.dtype)


def check_dtypes(x, dt, da, B, C) -> torch.dtype:
    """The launch's element type, from the dtypes alone: x, B and C one of
    fp32 and bf16 (``common.float_dtype``), dt and dA fp32. Raises
    otherwise."""
    elem = float_dtype("ssd_chunk_scan", {"x": x, "B": B, "C": C})
    if (dt, da) != (torch.float32, torch.float32):
        raise ValueError(f"ssd_chunk_scan: dt is {dt} and dA {da}; the "
                         "kernel takes both as torch.float32")
    return elem


def _check(x, dt, da, B, C):
    check_dtypes(x.dtype, dt.dtype, da.dtype, B.dtype, C.dtype)
    # dt and dA are the operands of one fixed dtype (fp32), as a page
    # table is elsewhere (int32)
    check_inputs("ssd_chunk_scan", {"x": x, "B": B, "C": C},
                 {"dt": dt, "dA": da}, strided=("x", "dt", "dA", "B", "C"),
                 int_dtype=torch.float32)
    if dt.stride() != da.stride() or B.stride() != C.stride():
        raise ValueError("ssd_chunk_scan: dt and dA, and B and C, must "
                         "share strides")


def ssd_chunk_scan(x, dt, dacum, B, C):
    """The TPU kernel's contract: x (BC, H, l, P); dt, dacum (BC, H, l, 1);
    B, C (BC, l, N), shared across heads (the kernel reads them once per
    head through their strides: no per-head copies). Returns
    (y (BC, H, l, P), states (BC, H, N, P)), both fp32 and contiguous."""
    BC, H, l, P = x.shape
    N = B.shape[-1]
    if dt.shape != (BC, H, l, 1) or dacum.shape != dt.shape \
            or B.shape != (BC, l, N) or C.shape != B.shape:
        raise ValueError(f"ssd_chunk_scan: dt {tuple(dt.shape)}, dA "
                         f"{tuple(dacum.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, dacum, B, C)
    dt3, da3 = dt[..., 0], dacum[..., 0]
    _check(x, dt3, da3, B, C)
    y = torch.empty((BC, H, l, P), dtype=torch.float32, device=x.device)
    st = torch.empty((BC, H, N, P), dtype=torch.float32, device=x.device)
    _launch(x, dt3, da3, B, C, y, st, (BC, H, l, P, N), x.stride()[:3],
            dt3.stride(), B.stride()[:2], y.stride()[:3], st.stride())
    return y, st


ssd_chunk_scan.launches = 0
ssd_chunk_scan.launches_by_dtype = {}


def ssd_chunk(xs, dts, dA_cum, Bs, Cs):
    """Model layout: xs (b, nc, l, H, P); dts, dA_cum (b, nc, l, H);
    Bs, Cs (b, nc, l, N). Returns (y_diag (b, nc, l, H, P), states
    (b, nc, H, P, N)), fp32, as ``ssd_chunk_reference`` does. On the card
    the kernel reads the model layout and writes both outputs in it through
    strides, so no transpose is copied (the TPU wrapper transposes to the
    kernel's layout and back)."""
    b, nc, l, H, P = xs.shape
    N = Bs.shape[-1]
    if dts.shape != (b, nc, l, H) or dA_cum.shape != dts.shape \
            or Bs.shape != (b, nc, l, N) or Cs.shape != Bs.shape:
        raise ValueError(f"ssd_chunk: dts {tuple(dts.shape)}, dA_cum "
                         f"{tuple(dA_cum.shape)}, Bs {tuple(Bs.shape)}, Cs "
                         f"{tuple(Cs.shape)} do not fit xs {tuple(xs.shape)}")
    if xs.device.type == "cpu":
        return ssd_chunk_reference(xs, dts, dA_cum, Bs, Cs)
    # (b, nc) merge into one bc axis: a view wherever the strides allow
    x, dt, da = xs.flatten(0, 1), dts.flatten(0, 1), dA_cum.flatten(0, 1)
    Bf, Cf = Bs.flatten(0, 1), Cs.flatten(0, 1)
    _check(x, dt, da, Bf, Cf)
    y = torch.empty((b, nc, l, H, P), dtype=torch.float32, device=xs.device)
    st = torch.empty((b, nc, H, P, N), dtype=torch.float32, device=xs.device)
    xst, dst, yst, sst = x.stride(), dt.stride(), y.stride(), st.stride()
    _launch(x, dt, da, Bf, Cf, y, st, (b * nc, H, l, P, N),
            (xst[0], xst[2], xst[1]), (dst[0], dst[2], dst[1]),
            Bf.stride()[:2], (yst[1], yst[3], yst[2]),
            (sst[1], sst[2], sst[4], sst[3]))
    return y, st

"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer layer: the
serving paths of ``repro.models.ssm``.

Prefill runs the chunked SSD algorithm: the intra-chunk quadratic term and
each chunk's state come from the SSD chunk kernel
(``kernels/ssd_scan``), and the inter-chunk recurrence runs in plain
PyTorch. Decode keeps a constant-size recurrent state (B, H, P, N) and a
conv tail, and runs no kernel: one step is a few small products, as in the
reference. ``ssm_forward`` (training's full-sequence pass) comes with the
training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_reference
from .common import RMSNorm, dtype_of, empty_param, rmsnorm


class SSM(nn.Module):
    """Weights in the reference's layouts: ``w_in`` (D, 2 di + 2 N + H)
    projecting to z, x, B, C and dt; ``conv_w`` (cw, di + 2 N); ``A_log``,
    ``D`` and ``dt_bias`` (H,) fp32; ``norm``; ``w_out`` (di, D)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        dt = dtype_of(cfg)
        self.w_in = empty_param((D, 2 * di + 2 * N + H), dt, device)
        self.conv_w = empty_param((cfg.ssm_conv_width, di + 2 * N), dt,
                                  device)
        self.A_log = empty_param((H,), torch.float32, device)
        self.D = empty_param((H,), torch.float32, device)
        self.dt_bias = empty_param((H,), torch.float32, device)
        self.norm = RMSNorm(di, dt, device)
        self.w_out = empty_param((di, D), dt, device)


def _split_proj(zxbcdt, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _causal_conv(xBC, conv_w):
    """Depthwise causal conv over the sequence, as the reference's shifted
    sum (``F.conv1d`` would run in TF32 through cuDNN unless it is turned
    off). xBC: (B, S, C); conv_w: (W, C)."""
    W, S = conv_w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    return F.silu(sum(pad[:, i:i + S, :] * conv_w[i] for i in range(W)))


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD. x (b, S, H, P); dt (b, S, H); A (H,); B, C (b, S, N)
    (one group, broadcast over heads); S a multiple of ``chunk``. Returns
    (y (b, S, H, P), final_state (b, H, P, N) fp32).

    Math: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t; y_t = C_t . h_t.
    ``h0``: (b, H, P, N) state entering the sequence (None = zeros), so a
    prompt streams through several calls carrying ``final_state`` along.

    On the card one SSD chunk kernel launch covers every chunk, and the
    state recurrence and the inter-chunk output run in plain PyTorch, as
    the reference's Pallas branch does. On the CPU the chunks run one by
    one through the plain version, as the reference's jnp scan does, so
    only one chunk's (l, l) decay matrix is live at a time."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    if h0 is None:
        h0 = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    h0 = h0.float()
    xs = x.reshape(b, nc, chunk, H, P)
    dts = dt.reshape(b, nc, chunk, H).float()
    Bs = B.reshape(b, nc, chunk, N)
    Cs = C.reshape(b, nc, chunk, N)
    dA_cum = torch.cumsum(dts * A, dim=2)     # within-chunk; A negative
    run = _chunks_at_once if x.device.type == "cuda" else _chunk_by_chunk
    y, final = run(xs, dts, dA_cum, Bs, Cs, h0)
    return y.reshape(b, S, H, P).to(x.dtype), final


def _chunks_at_once(xs, dts, dA_cum, Bs, Cs, h0):
    """Every chunk's intra-chunk term and state in one ``ssd_chunk`` call,
    then the recurrence over chunks. Returns (y (b, nc, l, H, P), final)."""
    y_diag, states = ssd_ops.ssd_chunk(xs, dts, dA_cum, Bs, Cs)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])          # (b, nc, H)
    h, h_prev = h0, []
    for c in range(xs.shape[1]):
        h_prev.append(h)                                   # entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cs.float(),
                         torch.stack(h_prev, 1), torch.exp(dA_cum))
    return y_diag + y_off, h


def _chunk_by_chunk(xs, dts, dA_cum, Bs, Cs, h0):
    """The chunks in order through the plain ``ssd_chunk_reference``.
    Returns (y (b, nc, l, H, P), final)."""
    h, ys = h0, []
    for c in range(xs.shape[1]):
        dac, Cc = dA_cum[:, c], Cs[:, c]
        y_diag, st = ssd_chunk_reference(
            xs[:, c, None], dts[:, c, None], dac[:, None], Bs[:, c, None],
            Cc[:, None])
        y_off = torch.einsum("bln,bhpn,blh->blhp", Cc.float(), h,
                             torch.exp(dac))
        h = h * torch.exp(dac[:, -1, :])[..., None, None] + st[:, 0]
        ys.append(y_diag[:, 0] + y_off)
    return torch.stack(ys, 1), h


# ------------------------------------------------------------------ serving
def init_ssm_state(cfg, batch: int, n_layers: int, device="cuda"):
    """Zero decode state: SSD state ``h`` (n_layers, batch, H, P, N) fp32
    and the raw conv tail ``conv`` (n_layers, batch, cw - 1, di + 2 N)."""
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    ch = cfg.d_inner + 2 * N
    return {"h": torch.zeros((n_layers, batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1, ch),
                                dtype=dtype_of(cfg), device=device)}


def _gate_out(ssm: SSM, y, xs, z, cfg):
    """Skip term, gated norm and output projection of the mixer.
    y, xs (B, S, H, P); z (B, S, di). Returns (B, S, D)."""
    Bsz, S = y.shape[:2]
    y = y + xs * ssm.D[None, None, :, None].to(y.dtype)
    y = rmsnorm(ssm.norm, y.reshape(Bsz, S, cfg.d_inner) * F.silu(z),
                cfg.norm_eps)
    return y @ ssm.w_out


def ssm_prefill_chunk(ssm: SSM, x, h0, conv_tail, n_new, cfg):
    """One chunked-prefill step of the mixer (continuous serving).

    x: (B, C, D), of which the first ``n_new[b]`` rows are real tokens (the
    rest is bucket padding); h0: (B, H, P, N) fp32 state entering the chunk;
    conv_tail: (B, cw - 1, di + 2 N) raw (pre-silu) conv inputs preceding
    the chunk, zeros at the start of a prompt. Returns (y (B, C, D),
    h_final, conv_tail_new).

    Padding rows do not advance the state: their dt is zeroed, so the decay
    (exp(0 A) = 1) and the update (0 B x) are the identity and the state of
    an n_new = 0 row comes out exactly h0. The new tail ends at each row's
    last real token, so an n_new = 0 row keeps its tail verbatim."""
    Bsz, C, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    cw = cfg.ssm_conv_width
    z, xBC_raw, dt_raw = _split_proj(x @ ssm.w_in, cfg)
    # causal conv with carried left context: taps end at chunk position c
    buf = torch.cat([conv_tail, xBC_raw], dim=1)      # (B, cw - 1 + C, ch)
    xBC = F.silu(sum(buf[:, i:i + C, :] * ssm.conv_w[i] for i in range(cw)))
    xs = xBC[..., :di].reshape(Bsz, C, H, P)
    dt = F.softplus(dt_raw.float() + ssm.dt_bias)
    valid = torch.arange(C, device=x.device)[None, :] < n_new[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)
    y, h_final = ssd_chunked(xs, dt, -torch.exp(ssm.A_log),
                             xBC[..., di:di + N], xBC[..., di + N:], C,
                             h0=h0)
    # the cw - 1 raw inputs ending at each row's last real token: buf index
    # n_new - 1 + (cw - 1) is that token
    idx = n_new.long()[:, None] + torch.arange(cw - 1, device=x.device)
    tail = torch.gather(buf, 1, idx[..., None].expand(-1, -1, buf.shape[2]))
    return _gate_out(ssm, y, xs, z, cfg), h_final, tail


def ssm_decode_step(ssm: SSM, x_t, h, conv_tail, cfg):
    """One-token recurrent step. x_t (B, 1, D); h (B, H, P, N) fp32;
    conv_tail (B, cw - 1, di + 2 N). Returns (y_t (B, 1, D), h_new,
    conv_tail_new)."""
    Bsz = x_t.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    z, xBC_t, dt_raw = _split_proj(x_t[:, 0] @ ssm.w_in, cfg)
    window = torch.cat([conv_tail, xBC_t[:, None, :]], dim=1)  # (B, cw, ch)
    xBC = F.silu(torch.einsum("bwc,wc->bc", window, ssm.conv_w))
    xh = xBC[:, :di].reshape(Bsz, H, P).float()
    Bm, Cm = xBC[:, di:di + N].float(), xBC[:, di + N:].float()
    dt = F.softplus(dt_raw.float() + ssm.dt_bias)               # (B, H)
    dec = torch.exp(dt * -torch.exp(ssm.A_log))
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xh)
    h_new = h * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, h_new) + xh * ssm.D[None, :, None]
    y = rmsnorm(ssm.norm, y.reshape(Bsz, di).to(x_t.dtype) * F.silu(z),
                cfg.norm_eps)
    return (y @ ssm.w_out)[:, None, :], h_new, window[:, 1:]

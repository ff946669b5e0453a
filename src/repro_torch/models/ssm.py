"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer layer: the
serving paths of ``repro.models.ssm``.

Prefill runs the chunked SSD algorithm: the intra-chunk quadratic term and
each chunk's state come from the SSD chunk kernel
(``kernels/ssd_scan``), and the inter-chunk recurrence runs in plain
PyTorch. Decode keeps a constant-size recurrent state (B, H, P, N) and a
conv tail, and runs no kernel: one step is a few small products, as in the
reference. ``ssm_forward`` is training's full-sequence pass: the same
chunked algorithm in plain PyTorch under autograd, on any device, as the
reference's training runs it (``use_pallas=False``; no Pallas kernel of
the repo has a backward pass).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_reference
from repro_torch.sharding import layers as mesh_layers
from repro_torch.sharding.context import cache_zeros, sequence_scatter
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


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None, plain: bool = False):
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
    only one chunk's (l, l) decay matrix is live at a time; ``plain``
    takes that path on the card too (differentiable, no kernel)."""
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
    run = _chunk_by_chunk if plain or x.device.type != "cuda" \
        else _chunks_at_once
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


def _full_sequence(ssm: SSM, x, cfg, plain: bool):
    """The mixer over whole sequences x (B, S, D), S padded to a multiple
    of ``cfg.ssm_chunk`` with dt = 0 rows (which leave the state as it
    is). Returns (y (B, S, D), final state (B, H, P, N), the raw conv
    inputs xBC (B, S, di + 2 N))."""
    zxbcdt = x @ ssm.w_in
    if not hasattr(zxbcdt, "device_mesh"):
        y, final, xBC_raw = _mixer(ssm, zxbcdt, cfg, plain)
        return y @ ssm.w_out, final, xBC_raw
    # on a launcher's mesh each rank runs the mixer on its own rows (the
    # scan is per row) with the small weights whole; the projections
    # stay DTensor products
    y, final, xBC_raw = mesh_layers.on_rows(
        lambda w, z: _mixer(w, z, cfg, plain),
        mesh_layers.whole_params(ssm, _MIXER_WEIGHTS), zxbcdt)
    return sequence_scatter(y @ ssm.w_out), final, xBC_raw


# the mixer's small weights, whole on each rank of a launcher's mesh
_MIXER_WEIGHTS = ("conv_w", "dt_bias", "A_log", "D", "norm")


def _mixer(ssm, zxbcdt, cfg, plain: bool):
    """The mixer between its two projections: conv, SSD scan and gated
    norm over (B, S, ...) rows. Returns (y (B, S, di), final state,
    xBC_raw)."""
    Bsz, S, _ = zxbcdt.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    z, xBC_raw, dt_raw = _split_proj(zxbcdt, cfg)
    xBC = _causal_conv(xBC_raw, ssm.conv_w)
    xs = xBC[..., :di].reshape(Bsz, S, H, P)
    Bmat, Cmat = xBC[..., di:di + N], xBC[..., di + N:]
    dt = F.softplus(dt_raw.float() + ssm.dt_bias)
    pad = (-S) % cfg.ssm_chunk
    xs_p, dt_p, B_p, C_p = xs, dt, Bmat, Cmat
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt_p, B_p, C_p = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bmat, Cmat))
    y, final = ssd_chunked(xs_p, dt_p, -torch.exp(ssm.A_log), B_p, C_p,
                           cfg.ssm_chunk, plain=plain)
    return _gate(ssm, y[:, :S], xs, z, cfg), final, xBC_raw


def ssm_forward(ssm: SSM, x, cfg):
    """Full-sequence SSD mixer for training's teacher-forced pass,
    differentiable: the chunks in order through the plain version under
    autograd, on any device; no kernel launches. x: (B, S, D) ->
    (B, S, D)."""
    return _full_sequence(ssm, x, cfg, plain=True)[0]


def ssm_prefill(ssm: SSM, x, cfg):
    """The mixer over a whole prompt x (B, S, D), through the SSD chunk
    kernel on the card. Returns (y (B, S, D), final state (B, H, P, N),
    raw conv tail (B, cw - 1, di + 2 N) for decoding)."""
    S, cw = x.shape[1], cfg.ssm_conv_width
    y, final, xBC_raw = _full_sequence(ssm, x, cfg, plain=False)
    if S < cw - 1:   # tiny prompts: left-pad the tail with zeros
        tail = F.pad(xBC_raw, (0, 0, cw - 1 - S, 0))
    else:
        tail = xBC_raw[:, S - (cw - 1):]
    return y, final, tail


# ------------------------------------------------------------------ serving
def init_ssm_state(cfg, batch: int, n_layers: int, device="cuda",
                   like=None):
    """Zero decode state: SSD state ``h`` (n_layers, batch, H, P, N) fp32
    and the raw conv tail ``conv`` (n_layers, batch, cw - 1, di + 2 N)
    (sharded like ``like``: ``sharding.context.cache_zeros``)."""
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    ch = cfg.d_inner + 2 * N
    return {"h": cache_zeros("ssm_h", (n_layers, batch, H, P, N),
                             torch.float32, device, batch, like),
            "conv": cache_zeros("ssm_conv",
                                (n_layers, batch, cfg.ssm_conv_width - 1, ch),
                                dtype_of(cfg), device, batch, like)}


def _gate(ssm: SSM, y, xs, z, cfg):
    """Skip term and gated norm of the mixer. y, xs (B, S, H, P); z (B,
    S, di). Returns (B, S, di), the output projection's input."""
    Bsz, S = y.shape[:2]
    y = y + xs * ssm.D[None, None, :, None].to(y.dtype)
    return rmsnorm(ssm.norm, y.reshape(Bsz, S, cfg.d_inner) * F.silu(z),
                   cfg.norm_eps)


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
    return _gate(ssm, y, xs, z, cfg) @ ssm.w_out, h_final, tail


def ssm_decode_step(ssm: SSM, x_t, h, conv_tail, cfg):
    """One-token recurrent step. x_t (B, 1, D); h (B, H, P, N) fp32;
    conv_tail (B, cw - 1, di + 2 N). Returns (y_t (B, 1, D), h_new,
    conv_tail_new). On a launcher's mesh each rank steps its own rows."""
    zxbcdt = x_t[:, 0] @ ssm.w_in
    if any(hasattr(t, "device_mesh") for t in (zxbcdt, h, conv_tail)):
        y, h_new, tail = mesh_layers.on_rows(
            lambda w, *rows: _decode_mixer(w, *rows, cfg),
            mesh_layers.whole_params(ssm, _MIXER_WEIGHTS), zxbcdt, h,
            conv_tail)
    else:
        y, h_new, tail = _decode_mixer(ssm, zxbcdt, h, conv_tail, cfg)
    return (y.to(x_t.dtype) @ ssm.w_out)[:, None, :], h_new, tail


def _decode_mixer(ssm, zxbcdt, h, conv_tail, cfg):
    """The step between the two projections: (y (B, di) gated and
    normed, h_new, conv_tail_new)."""
    Bsz = zxbcdt.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    z, xBC_t, dt_raw = _split_proj(zxbcdt, cfg)
    window = torch.cat([conv_tail, xBC_t[:, None, :]], dim=1)  # (B, cw, ch)
    xBC = F.silu(torch.einsum("bwc,wc->bc", window, ssm.conv_w))
    xh = xBC[:, :di].reshape(Bsz, H, P).float()
    Bm, Cm = xBC[:, di:di + N].float(), xBC[:, di + N:].float()
    dt = F.softplus(dt_raw.float() + ssm.dt_bias)               # (B, H)
    dec = torch.exp(dt * -torch.exp(ssm.A_log))
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xh)
    h_new = h * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, h_new) + xh * ssm.D[None, :, None]
    y = rmsnorm(ssm.norm, y.reshape(Bsz, di).to(zxbcdt.dtype) * F.silu(z),
                cfg.norm_eps)
    return y, h_new, window[:, 1:]

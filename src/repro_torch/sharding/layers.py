"""Each rank's compute on a launcher's mesh (DTensor weights and
activations, ``launch.dryrun``).

The models call these where a weight or an activation is a DTensor; on
plain tensors they never get here. DTensor would choose the layouts of
these operations itself, and its rules cannot split or flatten every
sharded dim they would produce (qwen's 40 heads on a "model" axis of 16),
so each function runs the layer's own computation on this rank's local
shards and hands back a DTensor of the global shape:

  * ``proj`` / ``out_proj``: the attention projections, heads on "model"
    where the rules shard them; FSDP (the weight gathered over "data") for
    batch-sharded rows, weights-stationary partial sums over "data" for
    decode's replicated token;
  * ``attend`` / ``decode_core``: the attention cores on the batch (data
    axes) and heads ("model") a rank holds, or its query positions under
    sequence parallelism;
  * ``embed``, ``picked`` and ``logsumexp``: the vocab sharded on "model";
  * ``on_rows`` / ``whole_params``: a per-row computation (the SSM mixer
    and its decode step) on this rank's batch rows, its small weights
    whole; ``rows_of`` / ``from_rows`` the same for the MoE dispatch.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import context as shard_ctx
from .context import (batch_axis_name, contiguous_strides, from_shard,
                      local_shard, partial_sum)
from .rules import axis_sizes, batch_axes, placements


def _batch_sharded(x) -> bool:
    """True when ``x`` is a DTensor whose dim 0 is sharded."""
    return hasattr(x, "device_mesh") and any(
        p.is_shard() and p.dim == 0 for p in x.placements)


# ------------------------------------------------------------- projections
def proj(x, w):
    """einsum("bsd,dhk->bshk") with ``w`` (D, H, Dh) a DTensor, kept
    sharded on "model" where the rules shard its heads. Batch-sharded rows
    (train, prefill) multiply the weight gathered over "data" (FSDP).
    Replicated rows (decode's one token) leave the weight where it is:
    each rank contracts its share of D into a partial sum over "data", as
    the reference's weights-stationary decode does. DTensor would pick the
    layout itself and might shard the flattened head dims unevenly, which
    it cannot then split into (H, Dh)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    m = names.index("model") if "model" in names else None
    heads = "model" if m is not None and w.placements[m].is_shard() else None
    ba = batch_axes(mesh, x.shape[0]) if _batch_sharded(x) else None
    D, H, Dh = w.shape
    shape = (*x.shape[:-1], H, Dh)
    stay = ba is None and "data" in names \
        and w.placements[names.index("data")] == Shard(0)
    if not stay:
        wl = local_shard(w, mesh, (None, heads, None))
        xl = local_shard(x, mesh, (ba,) + (None,) * (x.ndim - 1))
        yl = (xl @ wl.reshape(D, -1)).reshape(*xl.shape[:-1], -1, Dh)
        return from_shard(yl, mesh, (ba,) + (None,) * (x.ndim - 2)
                          + (heads, None), shape)
    wl = local_shard(w, mesh, ("data", heads, None))
    n = wl.shape[0]
    lo = mesh.get_local_rank("data") * n
    xl = local_shard(x, mesh, (None,) * x.ndim)[..., lo:lo + n]
    yl = (xl @ wl.reshape(n, -1)).reshape(*xl.shape[:-1], -1, Dh)
    pl = [Partial() if name == "data" else
          Shard(x.ndim - 1) if name == "model" and heads else Replicate()
          for name in names]
    return DTensor.from_local(yl, mesh, tuple(pl), run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def out_proj(wo, out, B, S, H, Dh):
    """The attention's output projection with ``wo`` (H·Dh, D) a DTensor:
    where the rules shard wo's rows on "model" each rank multiplies its
    rows' share of the heads (its own heads when they are sharded alike)
    into a partial sum over "model", else the whole product. Batch-sharded
    rows multiply wo gathered over "data" (FSDP); replicated rows (decode)
    leave its output dim sharded on "data" where the rules put it, so the
    weight stays where it is. DTensor's own layout for the backward pass
    would shard the flattened head dims unevenly (qwen's 40 heads on
    16)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = wo.device_mesh
    names = mesh.mesh_dim_names
    m = names.index("model") if "model" in names else None
    rows = m is not None and wo.placements[m].is_shard()
    ba = batch_axes(mesh, B) if _batch_sharded(out) else None
    cols = "data" if (ba is None and "data" in names and wo.placements[
        names.index("data")] == Shard(1)) else None
    if out.ndim == 3:           # decode's (B, H, Dh)
        out = out.unsqueeze(1)
    heads = "model" if rows and out.placements[m].is_shard() else None
    ol = local_shard(out, mesh, (ba, None, heads, None))
    ol = ol.reshape(ol.shape[0], S, -1)
    if rows and heads is None:       # this rank's share of the rows
        n = H * Dh // mesh.shape[m]
        r = mesh.get_local_rank("model")
        ol = ol[..., r * n:(r + 1) * n]
    yl = ol @ local_shard(wo, mesh, ("model" if rows else None, cols))
    pl = list(placements((ba, None, cols), mesh))
    if rows:
        pl[m] = Partial()
    return shard_ctx.sequence_scatter(DTensor.from_local(
        yl, mesh, tuple(pl), run_check=False,
        shape=torch.Size((B, S, wo.shape[1])),
        stride=(S * wo.shape[1], wo.shape[1], 1)))


# --------------------------------------------------------- attention cores
def kv_for_heads(H: int, K: int, m: int, r: int = 0):
    """The KV heads [lo, hi) that query heads [r H/m, (r+1) H/m) read
    (query head h reads KV head h // (H / K)), or None when the shards'
    groups would not be uniform. With K a multiple of m they are
    rank r's own shard."""
    n, G = H // m, H // K
    if n % G and G % n:
        return None
    return (r * n) // G, ((r + 1) * n - 1) // G + 1


def attend(kernel, q, k, v, q_pos, *, causal: bool, window: int, chunk: int):
    """``models.attention._attend`` on a launcher's mesh: each rank attends
    its own rows, the batch on the data axes, the heads on "model" where
    both head counts divide it, else (under sequence parallelism) the
    query positions on "model"; the output comes back with the whole
    sequence. On the card a shard of whole sequences runs ``kernel`` (the
    flash wrapper). The kernel takes equal query and key lengths, so a
    query shard runs it over the whole sequence with the rank's rows in
    place and zeros elsewhere, and keeps its rows: a row reads only its own
    query and the keys, so they are exact whatever the other rows hold
    (the work repeats once a rank along "model"). On the CPU, and where
    ``kernel`` is None
    (training, cross-attention), the plain masked softmax runs by query
    chunks of ``chunk`` (the whole shard when 0), as the reference's jnp
    path chunks it."""
    from repro_torch.models.attention import _chunked_attention
    mesh = next(t.device_mesh for t in (q, k, v) if hasattr(t, "device_mesh"))
    B, S, H, _ = q.shape
    K = k.shape[2]
    m = axis_sizes(mesh).get("model", 1)
    heads = "model" if m > 1 and H % m == 0 and kv_for_heads(H, K, m) \
        else None
    seq = "model" if (heads is None and m > 1 and S > 1 and S % m == 0
                      and shard_ctx.sequence_parallel()) else None
    on_card = kernel is not None and q.device.type == "cuda"
    ba = batch_axes(mesh, B)
    ql = local_shard(q, mesh, (ba, seq, heads, None))
    kv_heads = heads if K % m == 0 else None
    kl, vl = (local_shard(t, mesh, (ba, None, kv_heads, None))
              for t in (k, v))
    if heads and kv_heads is None:   # this rank's query heads' KV heads
        lo, hi = kv_for_heads(H, K, m, mesh.get_local_rank("model"))
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    n = ql.shape[1]
    r = mesh.get_local_rank("model") if seq else 0
    if on_card and seq:
        whole = ql.new_zeros((ql.shape[0], S) + tuple(ql.shape[2:]))
        whole[:, r * n:(r + 1) * n] = ql
        out = kernel(whole, kl, vl)[:, r * n:(r + 1) * n].contiguous()
    elif on_card:
        out = kernel(ql, kl, vl).contiguous()
    else:
        out = _chunked_attention(ql, kl, vl, q_pos[r * n:(r + 1) * n],
                                 causal=causal, window=window,
                                 chunk=chunk or n)
    out = from_shard(out, mesh, (ba, seq, heads, None), q.shape)
    return shard_ctx.sequence_gather(out) if seq else out


def decode_core(kernel, q, keys, vals, valid):
    """``kernel`` (the dense decode wrapper: q (B, H, Dh), keys/vals (B,
    S, K, Dh), valid (B, S) int8) on each rank's rows of a launcher's
    mesh, heads on "model" where both head counts divide it."""
    mesh = next(t.device_mesh for t in (q, keys, vals)
                if hasattr(t, "device_mesh"))
    m = axis_sizes(mesh).get("model", 1)
    heads = "model" if m > 1 and q.shape[1] % m == 0 \
        and keys.shape[2] % m == 0 else None
    ba = batch_axes(mesh, q.shape[0])
    out = kernel(local_shard(q, mesh, (ba, heads, None)),
                 local_shard(keys, mesh, (ba, None, heads, None)),
                 local_shard(vals, mesh, (ba, None, heads, None)),
                 local_shard(valid, mesh, (ba, None)).contiguous())
    return from_shard(out, mesh, (ba, heads, None), q.shape)


# ------------------------------------------------------------------- vocab
def embed(table, tokens):
    """The tokens' rows of a DTensor table: each rank looks its rows up in
    the vocab shard it holds on "model" (the whole D gathered over
    "data"), a token another rank holds giving zeros, and the partial
    rows are summed over "model" (``context.partial_sum``), so the
    activations never change which dim is sharded (an all-to-all a CPU
    mesh would run as an all-gather)."""
    from torch.distributed.tensor import Shard
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    vocab = "model" in names and \
        table.placements[names.index("model")] == Shard(0)
    ba = batch_axis_name()
    spec = (ba,) + (None,) * tokens.ndim
    tok = local_shard(tokens, mesh, spec[:-1]).long()
    tl = local_shard(table, mesh, ("model" if vocab else None, None))
    shape = tuple(tokens.shape) + (table.shape[1],)
    if not vocab:
        return from_shard(F.embedding(tok, tl), mesh, spec, shape)
    n = tl.shape[0]
    idx = tok - mesh.get_local_rank("model") * n
    inside = (idx >= 0) & (idx < n)
    rows = F.embedding(idx.clamp(0, n - 1), tl) * inside[..., None]
    return partial_sum(rows, mesh, placements(spec, mesh),
                       names.index("model"), shape)


def picked(logits, labels):
    """The labels' logits from DTensor logits (a sharded vocab): the
    logits times a comparison of the labels with the vocab ids, laid out
    as the logits' vocab is (no whole (B, S, V) one-hot on any rank),
    summed over the vocab. Exact: every other term is a signed zero."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, last = logits.device_mesh, logits.ndim - 1
    local = logits.to_local()
    # this rank's labels and vocab ids, laid out as its logits
    lab_pl = tuple(p if p.is_shard() and p.dim < last else Replicate()
                   for p in logits.placements)
    lab = labels if hasattr(labels, "device_mesh") else DTensor.from_local(
        labels, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    lab = lab.redistribute(mesh, lab_pl).to_local().long()
    lo = sum(mesh.get_local_rank(i) * local.shape[-1]
             for i, p in enumerate(logits.placements) if p == Shard(last))
    ids = lo + torch.arange(local.shape[-1], device=local.device)
    hit = DTensor.from_local(ids == lab[..., None], mesh, logits.placements,
                             run_check=False, shape=logits.shape,
                             stride=contiguous_strides(logits.shape))
    return (logits * hit).sum(-1)


def logsumexp(logits):
    """logsumexp over the last dim of DTensor logits, its vocab sharded:
    each rank's max, reduced to the global max (a constant shift, no
    gradient), then each rank's sum of exponentials, summed over the
    vocab's mesh dims (``partial_sum``); the logits are never gathered
    (some DTensor releases gather a sharded dim a reduction runs over)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = logits.device_mesh, logits.ndim - 1
    vdims = [i for i, p in enumerate(logits.placements) if p == Shard(last)]
    if not vdims:
        return torch.logsumexp(logits, dim=-1)
    if len(vdims) > 1:       # the rules shard the vocab on "model" alone
        raise ValueError("the vocab is sharded over more than one mesh dim")
    lead = tuple(p if p.is_shard() and p.dim < last else Replicate()
                 for p in logits.placements)
    shape = tuple(logits.shape[:-1])
    local = logits.to_local()
    part = list(lead)
    for i in vdims:
        part[i] = Partial("max")
    m = DTensor.from_local(local.detach().amax(-1), mesh, tuple(part),
                           run_check=False, shape=torch.Size(shape),
                           stride=contiguous_strides(shape)) \
        .redistribute(mesh, lead).to_local()
    z = torch.exp(local - m[..., None]).sum(-1)
    z = partial_sum(z, mesh, lead, vdims[0], shape)
    m = DTensor.from_local(m, mesh, lead, run_check=False,
                           shape=torch.Size(shape),
                           stride=contiguous_strides(shape))
    return m + torch.log(z)


# --------------------------------------------------------- per-row compute
def whole_params(module, names):
    """The parameters (or child modules) ``names`` of ``module``, each
    whole on this rank as a plain tensor, in a namespace that stands in
    for the module."""
    def whole(obj):
        if isinstance(obj, torch.nn.Module):
            return SimpleNamespace(**{n: whole(p) for n, p in
                                      obj.named_parameters(recurse=False)})
        if not hasattr(obj, "device_mesh"):
            return obj
        return local_shard(obj, obj.device_mesh, (None,) * obj.ndim)
    return SimpleNamespace(**{n: whole(getattr(module, n)) for n in names})


def on_rows(fn, weights, *tensors):
    """``fn(weights, *rows)`` on this rank's batch rows: each of
    ``tensors`` (one batch B leading each; at least one a DTensor) cut to
    the rows the batch axes give this rank. ``fn``'s outputs, each (b,
    ...), come back as DTensors of batch B."""
    mesh = next(t.device_mesh for t in tensors if hasattr(t, "device_mesh"))
    B = tensors[0].shape[0]
    ba = batch_axes(mesh, B)
    spec = lambda t: (ba,) + (None,) * (t.ndim - 1)
    out = fn(weights, *(local_shard(t, mesh, spec(t)) for t in tensors))
    return tuple(from_shard(t, mesh, spec(t), (B,) + tuple(t.shape[1:]))
                 for t in out)


def rows_of(t, spec_tail: int):
    """A DTensor ``t`` as its local rows: batch-sharded as the activation
    context says, replicated elsewhere (a plain tensor is returned as
    it is). Returns (local tensor, (mesh, placements); None for a plain
    tensor)."""
    if not hasattr(t, "device_mesh"):
        return t, None
    mesh = t.device_mesh
    spec = (batch_axis_name(),) + (None,) * spec_tail
    return local_shard(t, mesh, spec), (mesh, placements(spec, mesh))


def from_rows(local, where):
    """Local rows back as a DTensor with ``rows_of``' placements (they
    shard dim 0 only, so they fit a tensor of any rank)."""
    if where is None:
        return local
    from torch.distributed.tensor import DTensor
    mesh, pl = where
    return DTensor.from_local(local, mesh, pl, run_check=False)

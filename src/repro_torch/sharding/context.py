"""Activation-sharding constraint context (the port of
``repro.sharding.context``).

With 2D (fsdp x tensor) weight sharding, the layer boundaries pin
activations batch-sharded, as production frameworks do with
``with_sharding_constraint``; models call ``constrain_batch(x)``, which
is a no-op unless a launcher installed a context and ``x`` is a
``DTensor``. On a plain tensor it costs one context-variable read.

Beside it, the helpers the models' mesh paths use, each the plain
operation (or its input as it is) on plain tensors: ``sequence_gather``
and ``sequence_scatter`` around the norms under sequence parallelism,
``vocab_layout`` for the loss, ``cache_zeros`` and ``write_seq`` for the
caches, ``local_shard`` / ``from_shard`` for the code a rank runs on its
own shard, ``redistribute`` and ``param_layout_grad`` for gradients of
one layout, and the flash-decode context.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_CTX = contextvars.ContextVar("activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes, seq_shard: bool = False):
    """batch_axes: mesh axis (or tuple) the leading batch dim shards over.

    seq_shard=True additionally shards dim 1 (sequence) of rank-3
    activations over the "model" axis — Megatron-style sequence
    parallelism, applied only when the sequence divides the axis."""
    token = _CTX.set((mesh, batch_axes, seq_shard))
    try:
        yield
    finally:
        _CTX.reset(token)


def _is_dtensor(x) -> bool:
    """True for a DTensor (without importing ``torch.distributed.tensor``,
    which the serving paths never need)."""
    return hasattr(x, "device_mesh")


def _redistribute(x, mesh, spec):
    from .rules import placements
    if not _is_dtensor(x):
        return x
    return redistribute(x, mesh, placements(spec, mesh))


def redistribute(x, mesh, pl):
    """``x.redistribute(mesh, pl)``, whose backward lays the gradient out
    as ``x`` was, a partial sum's as replicated (some DTensor releases
    would try to turn a sharded gradient back into a partial sum, which
    they cannot)."""
    if not any(p.is_partial() for p in x.placements):
        return x.redistribute(mesh, pl)
    return _Redistribute.apply(x, mesh, tuple(pl))


class _Redistribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.back = mesh, tuple(
            _replicate_if_partial(p) for p in x.placements)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.back), None, None


def param_layout_grad(p):
    """``p`` (a DTensor parameter) as it is, its gradient laid out as
    ``p`` is: a parameter used twice (tied embeddings) then gets two
    gradients of one layout, which autograd can add. Anything else is
    returned as it is."""
    if not _is_dtensor(p) or not p.requires_grad:
        return p
    return _GradAsParam.apply(p)


class _GradAsParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p):
        ctx.mesh, ctx.pl = p.device_mesh, p.placements
        return p.view_as(p)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.pl)


def partial_sum(local, mesh, out, partial_dim: int, shape):
    """The DTensor of global ``shape`` laid out by placements ``out``
    whose shards are each rank's ``local`` partial sums over mesh dim
    ``partial_dim``, summed (an all-reduce). Differentiable: each rank's
    partial takes the sum's gradient whole, as d sum / d part = 1."""
    from torch.distributed.tensor import DTensor, Partial
    out = tuple(out)
    pl = list(out)
    pl[partial_dim] = Partial()
    part = DTensor.from_local(local.detach(), mesh, tuple(pl),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))
    return _PartialSum.apply(local, part, mesh, out)


class _PartialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, part, mesh, out):
        ctx.mesh, ctx.out = mesh, out
        return part.redistribute(mesh, out)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.out).to_local(), None, None, \
            None


def _replicate_if_partial(p):
    from torch.distributed.tensor import Replicate
    return Replicate() if p.is_partial() else p


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def constrain_batch(x):
    """Pin a (B, ...) activation to batch-sharded (+ optionally
    seq-sharded) placements."""
    ctx = _CTX.get()
    if ctx is None or x.ndim == 0 or not _is_dtensor(x):
        return x
    mesh, ba, seq_shard = ctx
    dims = [ba] + [None] * (x.ndim - 1)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if (seq_shard and x.ndim == 3 and "model" in sizes
            and x.shape[1] % sizes["model"] == 0 and x.shape[1] > 1):
        dims[1] = "model"
    return _redistribute(x, mesh, tuple(dims))


def cache_zeros(name: str, shape, dtype, device, batch: int, like=None):
    """Zeros for the cache entry ``name`` (a prefill's fresh cache).
    Without an activation-sharding context, or when ``like`` (the
    activations) is not a DTensor, ``torch.zeros`` on ``device``;
    otherwise a DTensor sharded by ``rules.cache_spec`` whose local shard
    is ``like``'s local ``new_zeros`` (fake when ``like``'s is), as the
    reference's out_shardings place the cache a step returns."""
    ctx = _CTX.get()
    if ctx is None or not _is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from .rules import cache_spec, placements
    mesh = ctx[0]
    pl = placements(cache_spec(name, shape, mesh, batch), mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(like.to_local().new_zeros(local, dtype=dtype),
                              mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def sequence_gather(x):
    """The whole sequence of a (B, S, ...) activation that
    ``constrain_batch`` sharded over "model" (Megatron-style sequence
    parallelism: a norm runs on the sequence shard, the projection after
    it on the whole sequence, which DTensor cannot flatten with a
    sharded sequence dim); the batch stays sharded. Any other tensor is
    returned as it is."""
    ctx = _CTX.get()
    if ctx is None or not ctx[2] or x.ndim < 3 or not _is_dtensor(x):
        return x
    mesh = ctx[0]
    if "model" not in mesh.mesh_dim_names:
        return x
    from torch.distributed.tensor import Replicate, Shard
    m = mesh.mesh_dim_names.index("model")
    if x.placements[m] != Shard(1):
        return x
    pl = list(x.placements)
    pl[m] = Replicate()
    return redistribute(x, mesh, tuple(pl))


def sequence_scatter(y):
    """A sub-layer's (B, S, D) output on the residual stream's layout
    (``constrain_batch``'s, the sequence sharded over "model") under a
    context that shards the sequence, so that the residual add's backward
    hands the sub-layer a gradient laid out as its output was (a partial
    sum is reduce-scattered). Any other tensor is returned as it is."""
    ctx = _CTX.get()
    if ctx is None or not ctx[2]:
        return y
    return constrain_batch(y)


def vocab_layout(logits):
    """(B, ..., V) logits on a launcher's mesh laid out for the loss: the
    batch as the activations', the vocab on "model" where it divides it,
    a partial sum reduced. Any other tensor is returned as it is."""
    ctx = _CTX.get()
    if ctx is None or not _is_dtensor(logits):
        return logits
    mesh, ba, _ = ctx
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    vocab = "model" if m > 1 and logits.shape[-1] % m == 0 else None
    return _redistribute(logits, mesh, (ba,) + (None,) * (logits.ndim - 2)
                         + (vocab,))


def write_seq(layer, start: int, new) -> None:
    """``layer[:, start:start + n] = new`` in place: ``layer`` (B, Smax,
    ...) a cache layer, ``new`` (B, n, ...). A DTensor layer whose
    sequence is sharded takes the write shard by shard (each rank writes
    the positions it holds), since DTensor does not write a slice across
    its shards."""
    if not _is_dtensor(layer):
        layer[:, start:start + new.shape[1]] = new
        return
    from torch.distributed.tensor import Replicate
    mesh, local = layer.device_mesh, layer.to_local()
    pl, lo = [], 0
    for i, p in enumerate(layer.placements):
        if p.is_shard() and p.dim == 1:
            lo = mesh.get_local_rank(i) * local.shape[1]
            pl.append(Replicate())
        else:
            pl.append(p)
    if not _is_dtensor(new):
        from torch.distributed.tensor import DTensor
        new = DTensor.from_local(new, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    src = redistribute(new, mesh, tuple(pl)).to_local()
    a = max(start, lo)
    b = min(start + src.shape[1], lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = src[:, a - start:b - start]


def sequence_parallel() -> bool:
    """True under a context that shards the sequence over "model"."""
    ctx = _CTX.get()
    return bool(ctx and ctx[2])


def local_shard(t, mesh, spec):
    """The local shard of ``t`` laid out by ``spec`` on ``mesh``: a
    DTensor redistributed (differentiably), a plain tensor, the same on
    every rank, cut where the spec shards it."""
    from torch.distributed.tensor import DTensor, Replicate
    from .rules import placements
    if not _is_dtensor(t):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    return redistribute(t, mesh, placements(spec, mesh)).to_local()


def from_shard(local, mesh, spec, shape):
    """The DTensor of global ``shape`` whose shard on this rank, laid
    out by ``spec``, is ``local``."""
    from torch.distributed.tensor import DTensor
    from .rules import placements
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def constrain(x, *spec_dims):
    """Pin an activation to an explicit spec (given per dim)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    return _redistribute(x, ctx[0], spec_dims)


def batch_axis_name():
    ctx = _CTX.get()
    return None if ctx is None else ctx[1]


# --------------------------------------------------------------- flash decode
_FLASH_DECODE = contextvars.ContextVar("flash_decode", default=None)


@contextlib.contextmanager
def flash_decode(mesh, batch_axes=None):
    """Enable the sequence-sharded flash-decode attention path: KV caches
    are sequence-sharded over "model"; decode attention computes local
    partial softmax statistics per sequence shard and combines them with
    small all-reduces instead of gathering the cache
    (``models.attention._flash_decode_seq_sharded``)."""
    token = _FLASH_DECODE.set((mesh, batch_axes))
    try:
        yield
    finally:
        _FLASH_DECODE.reset(token)


def flash_decode_ctx():
    return _FLASH_DECODE.get()

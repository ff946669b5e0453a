"""Logical-axis sharding rules: param name + shape -> spec (the port of
``repro.sharding.rules``).

Centralised so every launcher shards identically. The layout is the
reference's, rule for rule:

  * 2D weight sharding: one dim on "model" (tensor parallel), one on "data"
    (FSDP).
  * divisibility-aware fallbacks: attention shards heads on "model" when
    the head count divides, else replicates on "model" (qwen's 40 heads,
    gemma3's 8, whisper's 20).
  * MoE experts shard on "model" when E divides (16-expert phi3.5/jamba);
    8-expert grok falls back to d_ff sharding inside each expert.
  * KV caches shard batch on "data", kv_heads on "model" when divisible,
    else the sequence (the flash-decode layout), else head_dim.
  * "pod" axis: pure data parallelism (batch / gradient all-reduce).

A spec is a tuple with one entry per tensor dim: a mesh axis name, a tuple
of names, or None, as ``PartitionSpec`` is. The rules read the port's
parameter names (``layers.<i>.attn.wq`` of shape (D, H, Dh)); the
reference reads stacked paths (``layers/attn/wq`` of shape (L, D, H, Dh))
and never shards a leading scan-stack dim, so the port's spec is the
reference's with its leading Nones dropped (two for the hybrid's
``blocks.<b>.mamba.<j>...``). The ``*_shardings`` functions turn specs
into DTensor placements over a ``DeviceMesh``: one ``Shard(d)`` or
``Replicate()`` per mesh dim. Every rule reads only the mesh's axis
sizes, so a mapping ``{axis name: size}`` stands in for a mesh.
``torch.distributed.tensor`` is imported only where placements are made,
so the models' import of ``sharding.context`` costs nothing.
"""
from __future__ import annotations

from typing import Mapping


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of a mapping, as is)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _div(mesh, axis: str, dim: int):
    n = _axis_size(mesh, axis)
    return axis if n > 1 and dim % n == 0 else None


def batch_axes(mesh, batch: int):
    """Largest data-parallel axis combo that divides the batch."""
    pod = _axis_size(mesh, "pod")
    data = _axis_size(mesh, "data")
    if pod > 1 and batch % (pod * data) == 0:
        return ("pod", "data")
    if batch % data == 0 and data > 1:
        return "data"
    return None


def _names(name: str) -> list:
    """A dotted module path without its layer / block / sub-layer
    indices: ``blocks.0.mamba.2.ssm.w_in`` -> [blocks, mamba, ssm, w_in]."""
    return [p for p in name.split(".") if not p.isdigit()]


def param_spec(name: str, shape, mesh, fsdp: bool = True,
               mode: str = "default") -> tuple:
    """Sharding rule for one parameter (trailing-dim semantics by name).

    mode="decode": weights-STATIONARY layout for single-token serving —
    every matmul either has its OUTPUT dim sharded (zero comms) or its
    CONTRACTED dim sharded 256-way (partial sums + a small all-reduce of
    one-token activations). No weight moves per step."""
    names = _names(name)
    last = names[-1] if names else ""
    parents = set(names[:-1])
    nd = len(shape)
    data = "data" if fsdp else None

    def d(axis, dim):
        return _div(mesh, axis, dim) if axis else None

    def pad(rule):   # left-pad with None (dims the rule does not name)
        rule = list(rule)
        return tuple([None] * (nd - len(rule)) + rule)

    if mode == "decode":
        both = ("data", "model")
        n_both = _axis_size(mesh, "data") * _axis_size(mesh, "model")

        def dd(dim):
            return both if dim % n_both == 0 else _div(mesh, "model", dim)

        if last == "table":                   # (V, D) lookup
            return (dd(shape[0]), None)
        if last == "w" and "head" in parents:  # (D, V)
            return (None, dd(shape[1]))
        if last in ("wq", "wk", "wv"):        # (D, H, Dh): outputs sharded
            h = d("model", shape[-2])
            return pad([None, h, d("data", shape[-1]) if h else
                        d("model", shape[-1])])
        if last in ("bq", "bk", "bv"):
            h = d("model", shape[-2])
            return pad([h, d("data", shape[-1]) if h else
                        d("model", shape[-1])])
        if last == "wo":                      # (H*Dh, D): contract sharded
            return pad([dd(shape[-2]), None])
        if "moe" in parents:
            if last in ("w_in", "w_glu"):     # (E, D, F): F out
                return pad([d("model", shape[-3]), None,
                            dd(shape[-1]) if not d("model", shape[-3])
                            else None])
            if last == "w_out":               # (E, F, D): F contract
                return pad([d("model", shape[-3]),
                            dd(shape[-2]) if not d("model", shape[-3])
                            else None, None])
            if last == "w_gate_logits":
                return pad([None, None])
        if "ssm" in parents:
            if last == "w_out":               # (di, D): contract sharded
                return pad([dd(shape[-2]), None])
            return (None,) * nd               # mixed-out in_proj: replicate
        if last in ("w_in", "w_glu", "w_gate"):   # (D, F): F out
            return pad([None, dd(shape[-1])])
        if last == "w_out":                   # (F, D): F contract
            return pad([dd(shape[-2]), None])
        return (None,) * nd

    if last == "table":                       # (V, D) embedding
        return (d("model", shape[0]), d(data, shape[1]))
    if last == "w" and "head" in parents:     # (D, V) output head
        return (d(data, shape[0]), d("model", shape[1]))
    if last in ("wq", "wk", "wv"):            # (D, H, Dh)
        # heads on model when divisible; otherwise REPLICATE on model
        # (Dh-sharding makes every attention contraction partial)
        h = d("model", shape[-2])
        return pad([d(data, shape[-3]), h, None])
    if last in ("bq", "bk", "bv"):            # (H, Dh)
        return pad([d("model", shape[-2]), None])
    if last == "wo":                          # (H*Dh, D)
        return pad([d("model", shape[-2]), d(data, shape[-1])])
    if "moe" in parents:
        if last in ("w_in", "w_glu"):         # (E, D, F)
            if d("model", shape[-3]):
                return pad(["model", d(data, shape[-2]), None])
            return pad([None, d(data, shape[-2]), d("model", shape[-1])])
        if last == "w_out":                   # (E, F, D)
            if d("model", shape[-3]):
                return pad(["model", None, d(data, shape[-1])])
            return pad([None, d("model", shape[-2]), d(data, shape[-1])])
        if last == "w_gate_logits":           # (D, E)
            return pad([d(data, shape[-2]), None])
    if "ssm" in parents:
        if last == "w_in":                    # (D, 2di+2N+H) mixed out dim
            return pad([d(data, shape[-2]), None])
        if last == "w_out":                   # (di, D)
            return pad([d("model", shape[-2]), d(data, shape[-1])])
        return (None,) * nd
    if last in ("w_in", "w_glu", "w_gate"):   # dense mlp (D, F)
        return pad([d(data, shape[-2]), d("model", shape[-1])])
    if last == "w_out":                       # dense mlp (F, D)
        return pad([d("model", shape[-2]), d(data, shape[-1])])
    return (None,) * nd                       # norms, biases, small tables


def cache_spec(name: str, shape, mesh, batch: int) -> tuple:
    """KV-cache / SSM-state sharding; ``name`` is the cache entry's key."""
    last = name.rsplit(".", 1)[-1]
    ba = batch_axes(mesh, batch)
    if last == "pos":
        return ()
    nd = len(shape)
    spec: list = [None] * nd
    for i, dim in enumerate(shape):
        if dim == batch:
            spec[i] = ba
            break
    if last in ("k", "v", "cross_k", "cross_v") and nd >= 2:
        kv = _div(mesh, "model", shape[-2])
        spec[-2] = kv
        if kv is None:
            # sequence-sharded cache (the flash-decode layout): softmax and
            # weighted sum reduce locally per sequence shard and combine by
            # small all-reduces, far cheaper than gathering the cache
            spec[-3] = _div(mesh, "model", shape[-3])
            if spec[-3] is None:
                spec[-1] = _div(mesh, "model", shape[-1])
    if last == "ssm_h":     # (..., B, H, P, N)
        spec[-3] = _div(mesh, "model", shape[-3])
    if last == "ssm_conv":  # (..., B, cw-1, C)
        spec[-1] = None
    return tuple(spec)


def placements(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements over ``mesh``: for each mesh dim,
    ``Shard(d)`` of the tensor dim whose entry names it, else
    ``Replicate()``. A dim named by a tuple of axes shards over each, the
    first axis major, as a ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _shape(s) -> tuple:
    """A shape from a tensor, a (shape, dtype) pair
    (``launch.inputs.params_specs``) or a shape."""
    if hasattr(s, "shape"):
        return tuple(s.shape)
    if len(s) == 2 and isinstance(s[0], tuple):
        return s[0]
    return tuple(s)


def params_shardings(shapes: Mapping, mesh, fsdp: bool = True,
                     mode: str = "default") -> dict:
    """{param name: placements} for ``shapes``, {name: shape, tensor or
    (shape, dtype)}."""
    return {n: placements(param_spec(n, _shape(s), mesh, fsdp, mode), mesh)
            for n, s in shapes.items()}


def cache_shardings(shapes: Mapping, mesh, batch: int) -> dict:
    """{cache key: placements}; non-tensor entries (``pos``) are left
    out."""
    return {n: placements(cache_spec(n, tuple(s.shape), mesh, batch), mesh)
            for n, s in shapes.items() if hasattr(s, "shape")}


def batch_shardings(shapes: Mapping, mesh, batch: int) -> dict:
    """{input name: placements}: the leading batch dim on
    ``batch_axes``."""
    ba = batch_axes(mesh, batch)
    return {n: placements((ba,) + (None,) * (len(s.shape) - 1), mesh)
            for n, s in shapes.items()}


def replicated(shapes: Mapping, mesh) -> dict:
    return {n: placements((), mesh) for n in shapes}

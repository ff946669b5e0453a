"""Multi-pod dry run: every (arch x input-shape) combination traced on the
production meshes, with per-device memory, FLOPs, collective bytes and the
roofline's terms (the port of ``repro.launch.dryrun``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-32b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each step with XLA for 512 placeholder
CPU devices and reads the compiled module's memory analysis and HLO. The
port runs each step once, eagerly, on the host: a fake process group of
256 or 512 ranks (``launch.mesh.fake_process_group``), the model,
optimizer state, cache and batch as DTensors over the production mesh
whose local shards are fake tensors (``FakeTensorMode``: shapes and
dtypes, no memory), sharded by ``sharding.rules``, under the activation
sharding and flash-decode contexts on the reference's conditions. Plain
tensors the step makes (positions, masks) count as replicated
(``implicit_replication``). Where DTensor's own rules fall short (the
attention projections and cores, the SSM mixer, the MoE dispatch, cache
writes) the models run each rank's shard explicitly; the steps on a
real gloo mesh match one device (``tests/test_torch_sharding.py``).
``launch.cost_analysis`` counts the step as it dispatches. It touches
no GPU and needs none.

Records keep the reference's keys, with these differences:
  * ``trace_s`` (the step's trace) in place of ``compile_s``;
  * ``memory``: ``argument_gb`` (the local shards of the step's arguments),
    ``output_gb`` (of its outputs), ``alias_gb`` (what the step updates in
    place and returns: params and optimizer state in train, the cache in
    decode, as the reference donates them), ``peak_gb`` (the counter's peak
    live bytes) and ``temp_gb`` = peak - argument - output + alias, the
    reference's identity solved for temp; ``params_gb`` and ``opt_gb`` are
    the parameters' and moments' share of ``argument_gb``;
  * no ``cost_analysis_flops_uncorrected``: XLA's uncorrected cost
    analysis counts a while body once, and eager dispatch has no loop to
    count once;
  * ``hbm_bytes_by_op``: the HBM proxy's eight largest ops, in bytes;
    ``peak_bytes_by_op``: what was live at the peak, by the op that made
    it.
Attention on the fake CPU shards runs the plain masked softmax by query
chunks of ``attn_chunk``, as the reference's jnp path chunks it. MoE
layers run the reference's capacity-buffer compute
(``models.moe.capacity_dispatch``; the card's default compute sizes its
products by the experts' counts, which fake tensors do not hold): a
one-device trace of an MoE config predicts the card's step run under the
same context. A
combination whose op DTensor cannot shard is recorded
``ok: false`` with its error, as the reference records a failed compile,
and the exit code is 1; nothing is replicated to make it pass.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.moe import capacity_dispatch
from repro_torch.sharding import rules
from repro_torch.sharding.context import (activation_sharding,
                                          contiguous_strides, flash_decode)
from .cost_analysis import CostCounter
from .inputs import dryrun_config, needs_windowed_decode
from .mesh import fake_process_group, make_production_mesh
from .roofline import roofline_terms
from .steps import step_for

GB = 1e9


def sharding_for_args(arg_specs, shape, mesh):
    """Placements matching ``step_for``'s arg order, each a {name:
    placements} map (``step`` and ``pos`` are host ints)."""
    batch = shape.global_batch
    if shape.kind == "train":
        p, opt, b = arg_specs
        return (rules.params_shardings(p, mesh),
                {"m": rules.params_shardings(opt["m"], mesh),
                 "v": rules.params_shardings(opt["v"], mesh)},
                rules.batch_shardings(b, mesh, batch))
    if shape.kind == "prefill":
        p, b = arg_specs
        return (rules.params_shardings(p, mesh),
                rules.batch_shardings(b, mesh, batch))
    p, c, tok = arg_specs
    return (rules.params_shardings(p, mesh),
            rules.cache_shardings(c, mesh, batch),
            rules.batch_shardings({"tokens": tok}, mesh, batch)["tokens"])


def _sharded(shape, dtype, mesh, placements):
    """A DTensor of global ``shape`` whose local shard is a fresh tensor
    (fake under ``FakeTensorMode``); a plain zero tensor when ``mesh`` is
    None (one device)."""
    if mesh is None:
        return torch.zeros(shape, dtype=dtype)
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def materialize(rcfg, arg_specs, shape, mesh):
    """The step's arguments: the model (built on ``meta``, every parameter
    replaced by its shard), optimizer state, cache and batch; plain fake
    tensors when ``mesh`` is None."""
    from .inputs import build_meta
    sh = sharding_for_args(arg_specs, shape, mesh) if mesh is not None \
        else None

    def place(i, name, shape_, dtype, group=None):
        where = sh[i] if sh else None
        if where is not None and group is not None:
            where = where[group]
        return _sharded(shape_, dtype, mesh, where[name] if where else None)

    model = build_meta(rcfg)
    for name, (s, dt) in arg_specs[0].items():
        mod, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod), leaf, torch.nn.Parameter(
            place(0, name, s, dt), requires_grad=False))
    if shape.kind == "train":
        state = {k: {n: place(1, n, s, dt, k)
                     for n, (s, dt) in arg_specs[1][k].items()}
                 for k in ("m", "v")}
        state["step"] = arg_specs[1]["step"]
        return (model, state, {n: place(2, n, t.shape, t.dtype)
                               for n, t in arg_specs[2].items()})
    if shape.kind == "prefill":
        return (model, {n: place(1, n, t.shape, t.dtype)
                        for n, t in arg_specs[1].items()})
    cache = {n: place(1, n, t.shape, t.dtype)
             if isinstance(t, torch.Tensor) else t
             for n, t in arg_specs[1].items()}
    tok = arg_specs[2]
    return (model, cache, _sharded(tok.shape, tok.dtype, mesh,
                                   sh[2] if sh else None))


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (a module
    counts its parameters), each storage once."""
    from torch.utils._pytree import tree_flatten
    leaves = []
    for t in tree_flatten(tree)[0]:
        leaves.extend(t.parameters() if isinstance(t, torch.nn.Module)
                      else [t])
    seen, total = set(), 0
    for t in leaves:
        if isinstance(t, torch.Tensor):
            st = getattr(t, "_local_tensor", t).untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


@contextlib.contextmanager
def step_contexts(rcfg, shape, mesh):
    """The contexts a step on ``mesh`` runs under, on the reference's
    conditions: activations batch-sharded at the layer boundaries
    (replicated in decode, one token each, so weights stay stationary),
    the sequence sharded over "model" in train and in a prefill whose
    heads do not divide it, the flash decode where the KV heads do not
    divide "model" and the sequence does; plain tensors the step makes
    count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    ba = rules.batch_axes(mesh, shape.global_batch)
    m = rules.axis_sizes(mesh).get("model", 1)
    ba_act = None if shape.kind == "decode" else ba
    seq_shard = (shape.kind == "train"
                 or (shape.kind == "prefill" and rcfg.n_heads
                     and rcfg.n_heads % m != 0))
    with contextlib.ExitStack() as ctx:
        if (shape.kind == "decode" and not needs_windowed_decode(rcfg, shape)
                and rcfg.n_kv_heads and rcfg.n_kv_heads % m != 0
                and shape.seq_len % m == 0):
            ctx.enter_context(flash_decode(mesh, ba))
        ctx.enter_context(activation_sharding(mesh, ba_act,
                                              seq_shard=bool(seq_shard)))
        ctx.enter_context(implicit_replication())
        yield


def trace_step(rcfg, shape, mesh=None, *, print_hlo: bool = False) -> dict:
    """Trace ``rcfg``'s step at ``shape`` once on fake tensors: over
    ``mesh`` as DTensors, or on one device (plain fake tensors) when
    ``mesh`` is None. Returns the record's memory, cost and roofline
    fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n_chips = mesh.size() if mesh is not None else 1
    t0 = time.monotonic()
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fm:
        fn, arg_specs, trips = step_for(rcfg, shape, fm)
        args = materialize(rcfg, arg_specs, shape, mesh)
    # on a mesh the step runs outside the fake mode: DTensor computes
    # shard offsets with small real tensors, which a fake mode around it
    # would turn into fake ones it cannot read; every tensor the step makes
    # from the arguments' fake shards is fake all the same
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(fm if mesh is None
                          else step_contexts(rcfg, shape, mesh))
        ctx.enter_context(capacity_dispatch())
        arg_b = _local_bytes(args)
        params_b = _local_bytes([args[0]])
        opt_b = _local_bytes([args[1]]) if shape.kind == "train" else 0
        counter = CostCounter(trips, record_ops=print_hlo)
        counter.track(args)
        with counter:
            out = fn(*args)
        if shape.kind == "train":
            out_b = params_b + opt_b + _local_bytes([out[2]])
            alias_b = params_b + opt_b
        else:
            out_b = _local_bytes([out[0], out[1]])
            alias_b = _local_bytes([args[1]]) if shape.kind == "decode" else 0
    costs = counter.costs()
    if print_hlo:
        print("\n".join(costs.ops))
    peak = costs.peak_bytes
    hbm = arg_b + costs.hbm_bytes
    rl = roofline_terms(rcfg, shape, flops_per_dev=costs.flops,
                        coll_bytes_per_dev=costs.collective_bytes,
                        hbm_bytes_per_dev=hbm, n_chips=n_chips)
    return {
        "trace_s": round(time.monotonic() - t0, 2),
        "memory": {"argument_gb": arg_b / GB, "output_gb": out_b / GB,
                   "temp_gb": max(0.0, peak - arg_b - out_b + alias_b) / GB,
                   "alias_gb": alias_b / GB, "peak_gb": peak / GB,
                   "params_gb": params_b / GB, "opt_gb": opt_b / GB},
        "flops_per_dev": costs.flops,
        "collective_bytes_per_dev": costs.collective_bytes,
        "collective_by_kind": costs.collective_by_kind,
        "hbm_bytes_per_dev": hbm,
        "hbm_bytes_by_op": dict(list(costs.hbm_by_op.items())[:8]),
        "peak_bytes_by_op": costs.peak_by_op,
        "while_trips": costs.while_trips,
        "roofline": rl.as_dict(),
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            print_hlo: bool = False) -> dict:
    shape = INPUT_SHAPES[shape_name]
    rcfg = dryrun_config(get_config(arch), shape)
    fake_process_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single", "chips": mesh.size(),
           "ok": False}
    rec.update(trace_step(rcfg, shape, mesh, print_hlo=print_hlo))
    rec["ok"] = True
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--print-hlo", action="store_true",
                    help="print the dispatched op list")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    archs = ARCH_IDS if args.all else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.all else (args.shape,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                try:
                    rec = run_one(arch, shape, multi, args.print_hlo)
                    rl = rec["roofline"]
                    print(f"[ok] {tag} trace={rec['trace_s']}s "
                          f"peak={rec['memory']['peak_gb']:.1f}GB "
                          f"c/m/coll={rl['compute_s']:.3f}/"
                          f"{rl['memory_s']:.3f}/{rl['collective_s']:.3f}s "
                          f"dom={rl['dominant']}", flush=True)
                except Exception as e:
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {tag}: {type(e).__name__}: "
                          f"{str(e)[:300]}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

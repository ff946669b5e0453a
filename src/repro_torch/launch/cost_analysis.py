"""A step's cost counted as its ops dispatch, per device: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference lowers a step with XLA and parses the partitioned HLO: dot
FLOPs, collective bytes by kind and an HBM proxy (every top-level
instruction's output bytes), multiplying while-loop bodies by their trip
counts. The port runs the step eagerly, here under ``FakeTensorMode`` with
DTensor parameters on a fake process group (``launch.dryrun``), or for
real on the card, and counts what dispatches:

  * dot FLOPs, 2·|out|·|contracted|, of ``mm``, ``addmm``, ``bmm`` and
    ``baddbmm`` (einsum and ``@`` reach these), on the LOCAL shards: a
    counter wrapped around DTensor code at the level the program calls it
    sees each op with its global shapes, which over-counts by the number
    of devices doing a share of it. So the counter reads the output's
    local shape, and divides the contraction by the size of every mesh dim
    on which the output is ``Partial`` (its contracted dim was sharded
    there). Replicated work is counted on every device, as the
    reference's per-device ``flops`` counts it;
  * collective bytes by kind (all-reduce, all-gather, reduce-scatter,
    all-to-all), by output size: the functional collectives DTensor
    issues while it redistributes, and those the model issues itself
    (the sequence-sharded flash decode);
  * the HBM proxy: the local output bytes of every op that writes memory
    (views write nothing; an in-place op writes its destination);
  * peak live bytes: every tensor the step's ops create, and the
    arguments registered with ``track``, counted from creation until its
    storage is freed; what was live at the peak, by the op that made it
    (snapshots taken as the peak grows by 5%).

Eager dispatch sees every layer's ops, so no trip correction is needed:
``while_trips`` holds ``launch.steps.trip_counts`` as it is.

Two dispatch modes do the counting. ``_OpMode``, on top, sees each op as
the program calls it, DTensor or plain, and reads its output's local
shards; a mode placed there never sees what DTensor does inside an op.
``_CommMode``, below it, returns ``NotImplemented`` for DTensor ops (as
``CommDebugMode`` does), so DTensor runs first and the local collectives
it issues reach the mode; it counts collectives only, because the local
ops below DTensor include the global-shape ops of DTensor's sharding
propagation, which compute no part of the step. ``CommDebugMode`` counts
collectives by op but not their bytes, and ``MemTracker`` tracks modules
and optimizer state of a real run, not the local shards of DTensor ops,
so neither is used.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten
_DOTS = {aten.mm.default: (0, 1), aten.addmm.default: (1, 2),
         aten.bmm.default: (0, 1), aten.baddbmm.default: (1, 2)}
_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"))
# ops that produce no HBM write (views, plumbing, uninitialised buffers)
_NO_TRAFFIC = {aten.detach.default, aten.lift_fresh.default,
               aten.alias.default, aten.empty.memory_format,
               aten.empty_like.default, aten.empty_strided.default,
               aten.new_empty.default}


@dataclasses.dataclass
class Costs:
    flops: float
    collective_bytes: float
    collective_by_kind: dict
    hbm_bytes: float          # output-buffer traffic proxy
    while_trips: dict
    peak_bytes: float
    ops: list                 # "op -> local output shapes", in order
    hbm_by_op: dict           # the HBM proxy's bytes by op, largest first
    peak_by_op: dict          # live bytes at (about) the peak, by the op
    #                           that made them ("argument": made before)


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _local(t):
    return t._local_tensor if isinstance(t, _dtensor_type()) else t


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter:
    """Context manager counting the ops run inside it (see the module
    docstring). ``track(tree)`` registers tensors made before the step
    (params, optimizer state, caches, inputs) toward the peak."""

    def __init__(self, trips: dict | None = None, record_ops: bool = False):
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.hbm_by_op: dict = defaultdict(float)
        self.by_kind: dict = defaultdict(float)
        self.live = 0
        self.peak = 0
        self.peak_by_op: dict = {}
        self._snapped = 0
        self.trips = dict(trips or {})
        self.record_ops = record_ops
        self.ops: list = []
        self._live: dict = {}     # storage key -> (bytes, the op that made it)
        self._modes = (_CommMode(self), _OpMode(self))

    # ---------------------------------------------------------- live bytes
    def _register(self, t, op: str = "argument") -> None:
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        try:
            st = _local(t).untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, op)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            if self.peak > 1.05 * self._snapped:   # what holds the peak
                self._snapped = self.peak
                by_op: dict = defaultdict(float)
                for nb, name in self._live.values():
                    by_op[name] += nb
                self.peak_by_op = dict(sorted(by_op.items(),
                                              key=lambda kv: -kv[1])[:8])
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._live.pop(key, None)
        self.live -= n

    def track(self, tree) -> None:
        """Count the tensors of ``tree`` (a module: its parameters) as
        live from now on."""
        for t in tree_flatten(tree)[0]:
            for x in (t.parameters() if isinstance(t, torch.nn.Module)
                      else (t,)):
                self._register(x)

    # ------------------------------------------------------------ counting
    def _dot(self, func, args, out) -> None:
        a, b = (args[i] for i in _DOTS[func])
        k = a.shape[-1]
        lo = _local(out)
        if lo is not out:      # a DTensor: the contraction's local share
            mesh = out.device_mesh
            for i, p in enumerate(out.placements):
                if p.is_partial():
                    k //= mesh.size(i)
        self.flops += 2.0 * lo.numel() * k

    def _op(self, func, args, out) -> None:
        if func in _DOTS:
            self._dot(func, args, out)
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        view = getattr(func, "is_view", False) or func in _NO_TRAFFIC
        if not view:
            n = sum(_nbytes(_local(o)) for o in outs)
            self.hbm_bytes += n
            self.hbm_by_op[str(func)] += n
        for o in outs:
            self._register(o, str(func))
        if self.record_ops:
            self.ops.append(f"{func} -> " + ", ".join(
                str(tuple(_local(o).shape)) for o in outs))

    def _collective(self, func, out) -> None:
        name = func.__name__ if hasattr(func, "__name__") else str(func)
        for key, kind in _KINDS:
            if key in name:
                outs = [o for o in tree_flatten(out)[0]
                        if isinstance(o, torch.Tensor)]
                self.by_kind[kind] += sum(_nbytes(o) for o in outs)
                for o in outs:
                    self._register(o, kind)
                if self.record_ops:
                    self.ops.append(f"{func} -> " + ", ".join(
                        str(tuple(o.shape)) for o in outs))
                return

    # ---------------------------------------------------------- the modes
    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False

    def costs(self) -> Costs:
        by_op = dict(sorted(self.hbm_by_op.items(), key=lambda kv: -kv[1]))
        return Costs(self.flops, float(sum(self.by_kind.values())),
                     dict(self.by_kind), self.hbm_bytes, self.trips,
                     float(self.peak), self.ops, by_op, self.peak_by_op)


def _is_collective(func) -> bool:
    return func.namespace in ("_c10d_functional", "c10d_functional",
                              "_c10d_functional_autograd")


class _OpMode(TorchDispatchMode):
    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_collective(func):
            self.counter._op(func, args, out)
        return out


class _CommMode(TorchDispatchMode):
    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        DTensor = _dtensor_type()
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _is_collective(func):
            self.counter._collective(func, out)
        return out


def analyze(fn, *args, trips: dict | None = None, track=None,
            record_ops: bool = False):
    """Run ``fn(*args)`` under a ``CostCounter``; returns (fn's result,
    ``Costs``). ``track``: tensors made before the step to count toward
    the peak (``args`` when None)."""
    counter = CostCounter(trips, record_ops)
    counter.track(args if track is None else track)
    with counter:
        result = fn(*args)
    return result, counter.costs()


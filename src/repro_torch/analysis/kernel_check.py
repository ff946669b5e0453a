"""Launch audit of the port's CUDA kernels: what each wrapper hands its C
entry, held against what the entry's source declares.

Each wrapper in ``kernels/<family>/ops.py`` calls a C entry of
``csrc/<family>.cu`` through ``ctypes`` (``kernels/common.py::launch``),
whose argument types come from the Python arguments at the first call.
So a wrong argument count, a float tensor where the source says
``const int*``, a stride that names memory the tensor does not hold, or a
page table whose walk misses keys the caller promised were inside it all
fail silently on the card. This pass turns those into findings:

* ``kernel-abi``         — a captured call against the parsed signature:
  the argument count (the stream is last and implicit), a tensor where the
  source has a pointer and a Python int where it has an ``int``, the
  pointee's dtype (``float`` fp32, ``int`` int32, ``int8_t`` int8,
  ``elem::bf16`` bf16, ``void`` anything), every int within a C int, and
  the return type the
  binding assumes (``int`` for a launch, ``long long`` for a query).
  ``query`` calls are checked against their signatures the same way.
* ``kernel-extent``      — for every pointer operand, the highest element
  offset the kernel can address from the ints passed (dimensions and
  strides by their C names in ``LAYOUTS``, contiguous where no strides
  are declared, the pool's reach from the walked page ids) lies inside
  the tensor's storage from its data pointer; a contiguous layout needs a
  contiguous tensor and a declared unit stride a unit-strided one; a
  workspace holds what its sizing query answered for the launch's own
  arguments.
* ``kernel-page-walk``   — for the paged kernels (``PAGE_WALKS``): the
  walk ``[pages_start, pages_end)`` lies inside the table's width, every
  page id in ``page_table[:, pages_start:pages_end]`` lies in ``[0, P)``,
  and every key a row may attend lies inside ``[pages_start * ps,
  pages_end * ps)``: for decode ``[max(0, seq_len - window), seq_len)``
  (``[0, seq_len)`` under global attention), for prefill the causal range
  of the rows ``start .. total`` with the window. This is the promise the
  wrappers' docstrings put on the caller, which no wrapper can check
  without a host sync. A serve may name the rows whose outputs it uses
  (``Recorder.rows_in_use``): the engine's decode step hands the kernel
  idle and prefilling slots too, whose garbage it masks.
* ``kernel-static-args`` — the ops/ref pair agrees on the threaded
  compile-time arguments ``pages_bound``, ``pages_start`` and ``window``:
  each one a public wrapper takes, a public ``ref.py`` function also
  takes and reads in its body.
* ``kernel-stale-spec``  — ``LAYOUTS`` or ``PAGE_WALKS`` names an entry or
  a parameter the sources lack, or a launch entry or pointer parameter
  has no declared layout (the spec must move with the code).
* ``kernel-uncovered``   — a ``kernels/*/`` family with no probe, a probe
  that captured no launch, or an ``extern "C"`` entry no probe reaches.

Capture: during a probe the names ``launch``, ``query`` and
``check_inputs`` in each family's ``ops`` module are swapped for shims
(the wrappers import them with ``from ..common import ...``, so patching
``common`` would reach nothing), as ``repro.analysis.pallas_check``
swaps ``pl.pallas_call``. On the CPU a wrapper takes its plain version
for a CPU tensor, so the probes put the float operands on the ``meta``
device (shapes and strides, no data) and the int operands (page tables,
``seq_lens``, ``start``, ``total``, ``valid``) on the CPU, whose values
the audit reads; ``query``'s shim answers 0. Live (``capture(live=True)``,
on the card) every call passes through to the real entry, and the int
operands are copied to the host at each launch.

Out of scope, each with its reason: the Pallas checker's grid rules
(``pallas-grid``, ``-block-divisibility``, ``-write-race``, ``-scratch``).
The grid lives in each ``.cu`` file's host code, where no Python sees it;
a launch over the card's limits already raises through ``launch``'s error
check; and a tile that is missed or written twice is caught by phase 3 of
``chip_smoke.py``, which holds each kernel against its plain version.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import ENTRY_SUFFIX, float_dtype
from .report import Finding

RULES = frozenset({
    "kernel-abi", "kernel-extent", "kernel-page-walk", "kernel-static-args",
    "kernel-stale-spec", "kernel-uncovered",
})
# the compile-time arguments threaded wrapper -> kernel -> plain version
AUDITED_STATIC_ARGS = ("pages_bound", "pages_start", "window")
SHIMMED = ("launch", "query", "check_inputs")
C_INT_MIN, C_INT_MAX = -2 ** 31, 2 ** 31 - 1
_POINTEES = {"float": torch.float32, "elem::bf16": torch.bfloat16,
             "int": torch.int32, "int8_t": torch.int8, "void": None}


# ------------------------------------------------------------ the C side
@dataclasses.dataclass(frozen=True)
class Param:
    ctype: str       # normalised: "const float*", "int", "void*"
    name: str

    @property
    def is_pointer(self) -> bool:
        return self.ctype.endswith("*")

    @property
    def pointee(self) -> str:
        return self.ctype[:-1].replace("const", "").strip()


@dataclasses.dataclass(frozen=True)
class Entry:
    """One ``extern "C"`` function of ``csrc/<lib>.cu``."""
    lib: str
    name: str
    ret: str
    params: Tuple[Param, ...]
    line: int

    @property
    def path(self) -> str:
        return f"csrc/{self.lib}.cu"

    @property
    def is_launch(self) -> bool:
        """A launch entry takes the stream last; a query takes ints."""
        return bool(self.params) and self.params[-1].ctype == "void*" \
            and self.params[-1].name == "stream"

    def int_names(self) -> set:
        return {p.name for p in self.params if p.ctype == "int"}


_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_EXTERN = re.compile(r'extern\s+"C"\s+([A-Za-z_][\w\s\*]*?)\s*\b(\w+)\s*'
                     r"\(([^)]*)\)\s*\{", re.S)


def _norm_type(text: str) -> str:
    return re.sub(r"\s*\*", "*", " ".join(text.split()))


def parse_entries(text: str, lib: str) -> Dict[str, Entry]:
    """Every ``extern "C" <ret> <name>(<params>) {`` of one source, with
    comments stripped (line numbers kept)."""
    text = _COMMENT.sub(lambda m: "\n" * m.group().count("\n"), text)
    out: Dict[str, Entry] = {}
    for m in _EXTERN.finditer(text):
        params = []
        for raw in m.group(3).split(","):
            raw = " ".join(raw.split())
            if not raw or raw == "void":
                continue
            pm = re.match(r"(.*?)(\w+)$", raw)
            params.append(Param(_norm_type(pm.group(1)), pm.group(2)))
        out[m.group(2)] = Entry(lib, m.group(2), _norm_type(m.group(1)),
                                tuple(params),
                                text.count("\n", 0, m.start()) + 1)
    return out


def read_entries(csrc: Path) -> Dict[str, Entry]:
    """Every ``extern "C"`` entry of ``csrc/*.cu``, by name."""
    out: Dict[str, Entry] = {}
    for src in sorted(Path(csrc).glob("*.cu")):
        out.update(parse_entries(src.read_text(), src.stem))
    return out


# -------------------------------------------------------------- layouts
PAGES = "<pages>"   # a dimension: the pool pages the walked ids reach


@dataclasses.dataclass(frozen=True)
class Array:
    """A pointer operand read as an array: ``dims`` and ``strides`` (in
    elements) by the C names of the int parameters that give them, or
    literal ints; ``strides=None`` reads it as contiguous. ``PAGES`` as a
    dimension is the page count the walked page ids reach."""
    dims: Tuple
    strides: Optional[Tuple] = None


@dataclasses.dataclass(frozen=True)
class Workspace:
    """A scratch operand of as many bytes as the query entry ``query``
    answers, its parameters named as the launch's."""
    query: str


_POOL = Array((PAGES, "ps", "K", "D"))
# per launch entry: its pointer parameters' layouts, as the source's
# comments above each entry state them
LAYOUTS: Dict[str, Dict[str, object]] = {
    "decode_attention_f32": {
        "q": Array(("B", "K", "G", "D")),
        "k": Array(("B", "S", "K", "D"), ("sb", "ss", "sh", 1)),
        "v": Array(("B", "S", "K", "D"), ("sb", "ss", "sh", 1)),
        "valid": Array(("B", "S")),
        "out": Array(("B", "K", "G", "D")),
        "workspace": Workspace("decode_attention_workspace_bytes"),
    },
    "flash_attention_f32": {
        "q": Array(("B", "S", "H", "D"), ("q_sb", "q_ss", "q_sh", 1)),
        "k": Array(("B", "S", "K", "D"), ("k_sb", "k_ss", "k_sh", 1)),
        "v": Array(("B", "S", "K", "D"), ("k_sb", "k_ss", "k_sh", 1)),
        "out": Array(("B", "S", "H", "D")),
    },
    "paged_decode_attention_f32": {
        "q": Array(("B", "K", "G", "D")),
        "k_pages": _POOL,
        "v_pages": _POOL,
        "page_table": Array(("B", "MP")),
        "seq_lens": Array(("B",)),
        "out": Array(("B", "K", "G", "D")),
        "workspace": Workspace("paged_decode_workspace_bytes"),
    },
    "paged_prefill_attention_f32": {
        "q": Array(("B", "K", "C", "G", "D")),
        "k_pages": _POOL,
        "v_pages": _POOL,
        "page_table": Array(("B", "MP")),
        "start": Array(("B",)),
        "total": Array(("B",)),
        "out": Array(("B", "K", "C", "G", "D")),
        "workspace": Workspace("paged_prefill_workspace_bytes"),
    },
    "ssd_chunk_scan_f32": {
        "x": Array(("BC", "H", "l", "P"), ("x_sbc", "x_sh", "x_sl", 1)),
        "dt": Array(("BC", "H", "l"), ("d_sbc", "d_sh", "d_sl")),
        "da": Array(("BC", "H", "l"), ("d_sbc", "d_sh", "d_sl")),
        "B": Array(("BC", "l", "N"), ("b_sbc", "b_sl", 1)),
        "C": Array(("BC", "l", "N"), ("b_sbc", "b_sl", 1)),
        "y": Array(("BC", "H", "l", "P"), ("y_sbc", "y_sh", "y_sl", 1)),
        "st": Array(("BC", "H", "N", "P"),
                    ("s_sbc", "s_sh", "s_sn", "s_sp")),
    },
}


# the bf16 instances take their fp32 twins' layouts (the SSD scan's x, B
# and C as elem::bf16, its dt, dA, y and state as float: the dtypes come
# from the parsed signature)
LAYOUTS.update({name.replace("_f32", "_bf16"): LAYOUTS[name] for name in (
    "decode_attention_f32", "flash_attention_f32",
    "paged_decode_attention_f32", "paged_prefill_attention_f32",
    "ssd_chunk_scan_f32")})


@dataclasses.dataclass(frozen=True)
class Walk:
    """A paged kernel's walk, by its C parameter names. ``rows`` names the
    per-row key ranges: ``("seq_lens",)`` for decode (the keys before
    each row's length), ``("start", "total")`` for prefill (the causal
    range of the rows ``start .. total``)."""
    rows: Tuple[str, ...]
    table: str = "page_table"
    pools: Tuple[str, ...] = ("k_pages", "v_pages")


# the int parameters every page walk reads, by these names
WALK_INTS = ("ps", "pages_start", "pages_end", "window")


PAGE_WALKS: Dict[str, Walk] = {
    f"paged_{kind}_attention_{suffix}": Walk(rows)
    for kind, rows in (("decode", ("seq_lens",)),
                       ("prefill", ("start", "total")))
    for suffix in ("f32", "bf16")}


def check_layouts(entries: Dict[str, Entry],
                  layouts: Optional[Dict] = None,
                  walks: Optional[Dict] = None,
                  rules: Optional[frozenset] = None) -> List[Finding]:
    """``kernel-stale-spec``: the declared layouts and walks against the
    parsed signatures, both ways."""
    layouts = LAYOUTS if layouts is None else layouts
    walks = PAGE_WALKS if walks is None else walks
    rules = RULES if rules is None else frozenset(rules)
    out: List[Finding] = []
    if "kernel-stale-spec" not in rules:
        return out

    def emit(entry: Optional[Entry], name: str, msg: str) -> None:
        out.append(Finding(
            rule="kernel-stale-spec", path=entry.path if entry else
            "analysis/kernel_check.py", line=entry.line if entry else 0,
            symbol=name, message=msg))

    for name, layout in layouts.items():
        e = entries.get(name)
        if e is None:
            emit(None, name, "layout declared for an entry no csrc/*.cu "
                 "defines")
            continue
        ptrs = {p.name for p in e.params[:-1] if p.is_pointer}
        ints = e.int_names()
        for pname, spec in layout.items():
            if pname not in ptrs:
                emit(e, name, f"layout for {pname!r}, which is no pointer "
                     "parameter of the entry")
            if isinstance(spec, Array):
                for ref in tuple(spec.dims) + tuple(spec.strides or ()):
                    if isinstance(ref, str) and ref != PAGES \
                            and ref not in ints:
                        emit(e, name, f"{pname}'s layout names {ref!r}, "
                             "which is no int parameter of the entry")
            elif isinstance(spec, Workspace):
                q = entries.get(spec.query)
                if q is None:
                    emit(e, name, f"{pname} is sized by {spec.query!r}, "
                         "which no csrc/*.cu defines")
                else:
                    missing = [p.name for p in q.params
                               if p.name not in ints]
                    if missing:
                        emit(e, name, f"{spec.query} takes {missing}, "
                             "which the launch does not")
        for pname in sorted(ptrs - set(layout)):
            emit(e, name, f"pointer parameter {pname!r} has no declared "
                 "layout")
    for name, e in entries.items():
        if e.is_launch and name not in layouts:
            emit(e, name, "launch entry with no declared layout")
    for name, walk in walks.items():
        e = entries.get(name)
        if e is None:
            emit(None, name, "page walk declared for an entry no "
                 "csrc/*.cu defines")
            continue
        names = {p.name for p in e.params}
        for ref in walk.rows + (walk.table,) + walk.pools + WALK_INTS:
            if ref not in names:
                emit(e, name, f"the page walk names {ref!r}, which is no "
                     "parameter of the entry")
    return out


# -------------------------------------------------------------- capture
@dataclasses.dataclass(frozen=True)
class TensorArg:
    """What the audit needs of a tensor operand: its dtype and layout, the
    bytes from its data pointer to the end of its storage, and a host copy
    of an int32 operand's values (page tables, lengths)."""
    dtype: torch.dtype
    device: str
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]
    contiguous: bool
    itemsize: int
    nbytes: int
    values: Optional[np.ndarray] = None

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorArg":
        values = None
        if t.dtype == torch.int32 and t.device.type != "meta":
            values = t.detach().to("cpu").numpy().copy()
        return cls(t.dtype, t.device.type, tuple(t.shape), tuple(t.stride()),
                   t.is_contiguous(), t.element_size(),
                   t.untyped_storage().nbytes()
                   - t.storage_offset() * t.element_size(), values)


@dataclasses.dataclass
class Call:
    """One captured call of a C entry through a wrapper."""
    family: str          # kernels/<family> whose ops module made it
    lib: str             # csrc/<lib>.cu
    entry: str
    kind: str            # "launch" or "query"
    args: tuple          # TensorArg for a tensor, else as passed
    result: Optional[int] = None      # a query's answer
    mode: str = ""                    # the probe mode or serve it ran in
    rows: Optional[np.ndarray] = None  # rows whose outputs are used


class Recorder:
    """The shims' log. ``mode`` labels the calls that follow;
    ``rows_in_use`` (a bool per row, or None for every row) is what the
    page-walk rule holds a decode launch's rows to."""

    def __init__(self, live: bool):
        self.live = live
        self.calls: List[Call] = []
        self.mode = ""
        self.rows_in_use: Optional[np.ndarray] = None

    def shims(self, family: str, real: Dict[str, Callable]) -> Dict:
        def launch(name, entry, *args):
            self.calls.append(Call(
                family, name, entry, "launch",
                tuple(TensorArg.of(a) if isinstance(a, torch.Tensor) else a
                      for a in args), mode=self.mode,
                rows=self.rows_in_use))
            if self.live:
                real["launch"](name, entry, *args)

        def query(name, entry, *args):
            result = real["query"](name, entry, *args) if self.live else 0
            self.calls.append(Call(family, name, entry, "query", args,
                                   result, self.mode))
            return result

        def check_inputs(name, floats, ints, **kw):
            if self.live:
                return real["check_inputs"](name, floats, ints, **kw)
            return float_dtype(name, {a: t.dtype for a, t in floats.items()},
                               kw.get("dtypes", tuple(ENTRY_SUFFIX)))

        return {"launch": launch, "query": query,
                "check_inputs": check_inputs}


def family_modules(families: Sequence[str] = None) -> Dict[str, object]:
    """The ``ops`` modules of the port's kernel families."""
    return {f: importlib.import_module(f"repro_torch.kernels.{f}.ops")
            for f in (families or PROBES)}


@contextlib.contextmanager
def capture(live: bool = False, modules: Optional[Dict] = None):
    """Swap ``launch``, ``query`` and ``check_inputs`` in each family's
    ``ops`` module (``modules``: {family: module}, default every probed
    family) for the recorder's shims; yields the recorder. The wrappers'
    ``launches`` counters (and ``launches_by_dtype``) are restored on
    exit: an audit's launches count on no path."""
    modules = family_modules() if modules is None else modules
    rec = Recorder(live)
    saved = []
    for family, mod in modules.items():
        real = {n: getattr(mod, n) for n in SHIMMED if hasattr(mod, n)}
        counts = {f: (f.launches, dict(getattr(f, "launches_by_dtype", {})))
                  for f in vars(mod).values()
                  if callable(f) and hasattr(f, "launches")}
        saved.append((mod, real, counts))
        for n, shim in rec.shims(family, real).items():
            if n in real:
                setattr(mod, n, shim)
    try:
        yield rec
    finally:
        for mod, real, counts in saved:
            for n, f in real.items():
                setattr(mod, n, f)
            for f, (n, by_dtype) in counts.items():
                f.launches = n
                if hasattr(f, "launches_by_dtype"):
                    f.launches_by_dtype = by_dtype


# ---------------------------------------------------------------- probes
@dataclasses.dataclass
class Mode:
    """One structurally distinct launch: ``run`` calls the wrapper,
    ``plain`` its plain version on the same inputs (through the
    wrapper's CPU path); ``scaled``: the output's tolerance is relative
    to its largest magnitude (the SSD scan's sums reach tens)."""
    name: str
    run: Callable
    plain: Callable
    scaled: bool = False


class Inputs:
    """Probe inputs from one seed: float operands on ``fdev`` (``meta`` for
    the static audit), int operands on ``idev``."""

    def __init__(self, fdev, idev, seed: int = 0):
        self.fdev, self.idev = torch.device(fdev), torch.device(idev)
        self.rng = np.random.default_rng(seed)

    def f(self, *shape, scale: float = 1.0,
          dtype=torch.float32) -> torch.Tensor:
        a = (self.rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(self.fdev, dtype)

    def uniform(self, lo: float, hi: float, *shape) -> np.ndarray:
        return self.rng.uniform(lo, hi, shape).astype(np.float32)

    def put(self, a: np.ndarray) -> torch.Tensor:
        """A float array made by the caller, on the float device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.fdev)

    def i(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.idev)


def _plain(fn, *args, **kw):
    """``fn`` on CPU copies of its tensor arguments (the wrapper's plain
    version), its outputs back on the first argument's device."""
    dev = args[0].device
    out = fn(*[a.to("cpu") if isinstance(a, torch.Tensor) else a
               for a in args], **kw)
    if isinstance(out, tuple):
        return tuple(o.to(dev) for o in out)
    return out.to(dev)


def _mode(name, fn, *args, scaled=False, **kw) -> Mode:
    return Mode(name, lambda: fn(*args, **kw),
                lambda: _plain(fn, *args, **kw), scaled)


def _probe_paged_decode(mk: Inputs) -> List[Mode]:
    from repro_torch.kernels.paged_decode_attention import ops
    B, K, G, D, ps, P, MP = 3, 2, 2, 32, 8, 16, 6
    q = mk.f(B, K, G, D, scale=D ** -0.5)
    kp, vp = mk.f(P, ps, K, D), mk.f(P, ps, K, D)
    pt = mk.i(mk.rng.integers(1, P, (B, MP)))
    bf = [t.to(torch.bfloat16) for t in (q, kp, vp)]
    # the full table width, a live bound, and a window walked from page 2
    # (each row's window inside [16, 40)); the last slot idle; the window
    # walk again at bf16
    return [_mode(name, ops.paged_decode_attention_gqa, *floats, pt,
                  mk.i(lens), **kw) for name, floats, lens, kw in (
        ("full_walk", (q, kp, vp), [37, 9, 0], {}),
        ("live_bound", (q, kp, vp), [24, 17, 0], dict(pages_bound=3)),
        ("window_late_start", (q, kp, vp), [40, 26, 0],
         dict(pages_bound=5, pages_start=2, window=8)),
        ("bf16_window_late_start", bf, [40, 26, 0],
         dict(pages_bound=5, pages_start=2, window=8)))]


def _probe_paged_prefill(mk: Inputs) -> List[Mode]:
    from repro_torch.kernels.paged_prefill_attention import ops
    B, K, C, G, D, ps, P, MP = 3, 2, 4, 2, 32, 8, 16, 6
    q = mk.f(B, K, C, G, D, scale=D ** -0.5)
    kp, vp = mk.f(P, ps, K, D), mk.f(P, ps, K, D)
    pt = mk.i(mk.rng.integers(1, P, (B, MP)))
    bf = [t.to(torch.bfloat16) for t in (q, kp, vp)]
    # a full chunk and a ragged one per launch, the last row padding; each
    # walk again at bf16 (the bf16 design)
    walks = (("full_walk", [20, 3, 0], [24, 5, 0], {}),
             ("live_bound", [16, 9, 0], [20, 13, 0], dict(pages_bound=3)),
             ("window_late_start", [30, 25, 0], [34, 27, 0],
              dict(pages_bound=5, pages_start=2, window=8)))
    return [_mode(prefix + name, ops.paged_prefill_attention_gqa, *floats,
                  pt, mk.i(start), mk.i(total), **kw)
            for prefix, floats in (("", (q, kp, vp)), ("bf16_", bf))
            for name, start, total, kw in walks]


def _valid(mk: Inputs, *shape) -> torch.Tensor:
    v = mk.rng.random(shape) < 0.7
    v[..., 0] = True
    return mk.i(v, torch.int8)


def _probe_decode(mk: Inputs) -> List[Mode]:
    from repro_torch.kernels.decode_attention import ops
    BK, G, D, S = 4, 2, 32, 16
    q = mk.f(BK, G, D, scale=D ** -0.5)
    k, v = mk.f(BK, S, D), mk.f(BK, S, D)
    B, K, H, Sx = 2, 2, 4, 40
    qh = mk.f(B, H, D, scale=D ** -0.5)
    kv = mk.f(B, Sx, 2, K, D)          # k and v interleaved: strided views
    enc = mk.f(2, B, 150, K, D)        # a layer's slice of a cross cache
    return [
        _mode("gqa", ops.decode_attention_gqa, q, k, v, _valid(mk, BK, S)),
        # an S no split divides (the TPU kernel's padded path)
        _mode("gqa_irregular", ops.decode_attention_gqa, q, k[:, :12],
              v[:, :12], _valid(mk, BK, 12)),
        _mode("kv_strided", ops.decode_attention_kv, qh, kv[:, :, 0],
              kv[:, :, 1], _valid(mk, B, Sx)),
        _mode("head_expanded", ops.decode_attention, qh[:, None],
              kv[:, :, 0].repeat_interleave(H // K, 2),
              kv[:, :, 1].repeat_interleave(H // K, 2), _valid(mk, Sx)),
        # decode cross-attention: every encoder key valid, two splits
        _mode("cross", ops.decode_attention_kv, qh, enc[0], enc[1],
              mk.i(np.ones((B, 150)), torch.int8)),
        # the strided views again at bf16
        _mode("bf16_kv_strided", ops.decode_attention_kv,
              qh.to(torch.bfloat16), *kv.to(torch.bfloat16).unbind(2),
              _valid(mk, B, Sx)),
    ]


def _probe_flash(mk: Inputs) -> List[Mode]:
    from repro_torch.kernels.flash_attention import ops
    BH, S, D = 3, 40, 32
    q = mk.f(BH, S, D, scale=D ** -0.5)
    k, v = mk.f(BH, S, D), mk.f(BH, S, D)
    B, Sm, H, K, Dm = 2, 24, 4, 2, 16
    # q, k and v as views of one packed projection (the model's layout)
    qkv = mk.f(B, Sm, (H + 2 * K) * Dm)
    views = lambda t: (t[..., :H * Dm].view(B, Sm, H, Dm),
                       t[..., H * Dm:(H + K) * Dm].view(B, Sm, K, Dm),
                       t[..., (H + K) * Dm:].view(B, Sm, K, Dm))
    qm, km, vm = views(qkv)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    return [
        _mode("causal", ops.flash_attention_bhsd, q, k, v),
        _mode("window", ops.flash_attention_bhsd, q, k, v, window=8),
        _mode("non_causal", ops.flash_attention_bhsd, q, k, v,
              causal=False),
        _mode("irregular", ops.flash_attention_bhsd, q[:, :12], k[:, :12],
              v[:, :12]),
        _mode("gqa_strided", ops.flash_attention, qm, km, vm),
        # the packed projection's views again at bf16, q pre-scaled as the
        # model hands it over: the plain version rounds the scores to bf16
        # and the kernel does not, which at unscaled scores' magnitude
        # exceeds the bf16 tolerance
        _mode("bf16_gqa_strided", ops.flash_attention,
              *views(torch.cat([qkv[..., :H * Dm] * Dm ** -0.5,
                                qkv[..., H * Dm:]], -1).to(torch.bfloat16))),
        # the (BH, S, D) modes again at bf16 (q pre-scaled above)
        _mode("bf16_causal", ops.flash_attention_bhsd, qb, kb, vb),
        _mode("bf16_window", ops.flash_attention_bhsd, qb, kb, vb, window=8),
        _mode("bf16_non_causal", ops.flash_attention_bhsd, qb, kb, vb,
              causal=False),
        _mode("bf16_irregular", ops.flash_attention_bhsd, qb[:, :12],
              kb[:, :12], vb[:, :12]),
    ]


def _ssd_inputs(mk: Inputs, lead: tuple, l: int, H: int, head_axis: int):
    """dt > 0 and the within-chunk cumsum of dt * A (A < 0) over ``l``."""
    dt = mk.uniform(0.01, 0.1, *lead, l, H)
    A = -mk.uniform(0.5, 2.0, H)
    da = np.cumsum(dt * A, axis=-2)
    if head_axis != -1:
        dt, da = np.moveaxis(dt, -1, head_axis), np.moveaxis(da, -1,
                                                             head_axis)
    return mk.put(dt), mk.put(da)


def _probe_ssd(mk: Inputs) -> List[Mode]:
    from repro_torch.kernels.ssd_scan import ops
    BC, H, l, P, N = 3, 2, 8, 16, 8
    x = mk.f(BC, H, l, P)
    dt, da = _ssd_inputs(mk, (BC,), l, H, -2)        # (BC, H, l)
    Bk, Ck = mk.f(BC, l, N), mk.f(BC, l, N)
    b, nc, lm, Hm, Pm, Nm = 2, 2, 16, 4, 32, 16
    xs = mk.f(b, nc, lm, Hm, Pm)
    dts, dac = _ssd_inputs(mk, (b, nc), lm, Hm, -1)  # (b, nc, l, H)
    Bs, Cs = mk.f(b, nc, lm, Nm), mk.f(b, nc, lm, Nm)
    bf = lambda *ts: [t.to(torch.bfloat16) for t in ts]
    kx, kb, kc = bf(x, Bk, Ck)
    mx, mb, mc = bf(xs, Bs, Cs)
    return [
        _mode("kernel_layout", ops.ssd_chunk_scan, x, dt[..., None],
              da[..., None], Bk, Ck, scaled=True),
        _mode("model_layout", ops.ssd_chunk, xs, dts, dac, Bs, Cs,
              scaled=True),
        # both layouts again with x, B and C at bf16 (dt and dA fp32, the
        # outputs fp32: held at the fp32 tolerance)
        _mode("bf16_kernel_layout", ops.ssd_chunk_scan, kx, dt[..., None],
              da[..., None], kb, kc, scaled=True),
        _mode("bf16_model_layout", ops.ssd_chunk, mx, dts, dac, mb, mc,
              scaled=True),
    ]


PROBES: Dict[str, Callable[[Inputs], List[Mode]]] = {
    "paged_decode_attention": _probe_paged_decode,
    "paged_prefill_attention": _probe_paged_prefill,
    "decode_attention": _probe_decode,
    "flash_attention": _probe_flash,
    "ssd_scan": _probe_ssd,
}


def probe_modes(fdev="meta", idev="cpu", seed: int = 0,
                families: Sequence[str] = None) -> Dict[str, List[Mode]]:
    """Each family's modes, inputs made from ``seed``."""
    mk = Inputs(fdev, idev, seed)
    return {f: PROBES[f](mk) for f in (families or PROBES)}


# ---------------------------------------------------------------- audit
def _values(entry: Entry, args: tuple) -> Dict[str, object]:
    return {p.name: a for p, a in zip(entry.params, args)}


def _abi(entry: Entry, call: Call) -> List[str]:
    bad: List[str] = []
    if call.kind == "launch":
        if not entry.is_launch:
            return [f"launched with a stream, but the entry's last "
                    f"parameter is not 'void* stream' ({entry.ret} "
                    f"{entry.name}{tuple(p.ctype for p in entry.params)})"]
        params, ret = entry.params[:-1], "int"
    else:
        params, ret = entry.params, "long long"
    if entry.ret != ret:
        bad.append(f"the binding reads a {ret}, the entry returns "
                   f"{entry.ret}")
    if len(call.args) != len(params):
        bad.append(f"{len(call.args)} arguments for {len(params)} "
                   "parameters" + (" (plus the stream)"
                                   if call.kind == "launch" else ""))
    for p, a in zip(params, call.args):
        if p.is_pointer:
            if not isinstance(a, TensorArg):
                bad.append(f"{p.name} ({p.ctype}) gets {type(a).__name__}, "
                           "not a tensor")
                continue
            if p.pointee not in _POINTEES:
                bad.append(f"{p.name}: no dtype known for {p.ctype}")
            elif _POINTEES[p.pointee] not in (None, a.dtype):
                bad.append(f"{p.name} ({p.ctype}) gets a {a.dtype} tensor")
        elif p.ctype == "int":
            if isinstance(a, TensorArg) or isinstance(a, (bool, float)) \
                    or not isinstance(a, (int, np.integer)):
                bad.append(f"{p.name} (int) gets {type(a).__name__}")
            elif not C_INT_MIN <= int(a) <= C_INT_MAX:
                bad.append(f"{p.name} = {int(a)} overflows a C int")
        else:
            bad.append(f"{p.name}: the binding passes no {p.ctype}")
    return bad


def _walk_ids(walk: Walk, vals: Dict) -> Optional[np.ndarray]:
    table = vals.get(walk.table)
    if not isinstance(table, TensorArg) or table.values is None:
        return None
    return table.values[:, int(vals["pages_start"]):int(vals["pages_end"])]


def _extent(entry: Entry, call: Call, layout: Dict, walk: Optional[Walk],
            queries: Dict, entries: Dict[str, Entry]) -> List[str]:
    bad: List[str] = []
    vals = _values(entry, call.args)
    ids = _walk_ids(walk, vals) if walk is not None else None
    for pname, spec in layout.items():
        t = vals.get(pname)
        if not isinstance(t, TensorArg):
            continue
        if isinstance(spec, Workspace):
            sizer = entries.get(spec.query)
            q = None if sizer is None else queries.get((spec.query, tuple(
                int(vals[p.name]) for p in sizer.params)))
            if q is None:
                bad.append(f"{pname} was never sized by {spec.query} on "
                           "this launch's arguments")
            elif t.nbytes < q:
                bad.append(f"{pname} holds {t.nbytes} bytes, {spec.query} "
                           f"asks {q}")
            continue
        dims = []
        for d in spec.dims:
            if d == PAGES:
                if ids is None:
                    dims.append(1)
                else:
                    dims.append(int(ids.max()) + 1 if ids.size else 0)
            else:
                dims.append(int(vals[d]) if isinstance(d, str) else d)
        if spec.strides is None:
            strides, acc = [], 1
            for d in reversed(dims):
                strides.insert(0, acc)
                acc *= max(d, 1)
            if not t.contiguous:
                bad.append(f"{pname} is read as contiguous {tuple(dims)} "
                           f"but the tensor has strides {t.strides}")
        else:
            strides = [int(vals[s]) if isinstance(s, str) else s
                       for s in spec.strides]
            if spec.strides[-1] == 1 and t.strides and t.strides[-1] != 1:
                bad.append(f"{pname} is read at unit stride on its last "
                           f"dimension, the tensor's is {t.strides[-1]}")
        if any(d < 0 for d in dims):
            bad.append(f"{pname}: negative dimension in {tuple(dims)}")
            continue
        if any(d == 0 for d in dims):
            continue
        hi = sum((d - 1) * s for d, s in zip(dims, strides) if s > 0)
        lo = sum((d - 1) * s for d, s in zip(dims, strides) if s < 0)
        size = t.nbytes // t.itemsize
        if lo < 0 or hi >= size:
            bad.append(f"{pname} {tuple(dims)} at strides {tuple(strides)} "
                       f"addresses elements [{lo}, {hi}], the tensor's "
                       f"storage holds {size} from its data pointer")
    return bad


def page_walk_problems(table: np.ndarray, n_pages: int, ps: int,
                       pages_start: int, pages_end: int, window: int,
                       lens=None, start=None, total=None,
                       rows=None) -> List[str]:
    """What breaks the paged kernels' walk contract (see the module's
    ``kernel-page-walk``). ``lens`` for a decode launch, ``start`` and
    ``total`` for a prefill one; ``rows``: a bool per row whose outputs
    count (None: every row)."""
    bad: List[str] = []
    B, MP = table.shape
    if not 0 <= pages_start < pages_end <= MP:
        return [f"walk [{pages_start}, {pages_end}) outside the table's "
                f"{MP} columns"]
    ids = table[:, pages_start:pages_end]
    out = np.argwhere((ids < 0) | (ids >= n_pages))
    if len(out):
        b, c = out[0]
        bad.append(f"page_table[{b}, {pages_start + c}] = {ids[b, c]} "
                   f"outside the pool's {n_pages} pages ({len(out)} such "
                   "ids)")
    lo_key, hi_key = pages_start * ps, pages_end * ps
    for b in range(B):
        if rows is not None and not rows[b]:
            continue
        if lens is not None:
            hi = int(lens[b])
            lo = max(0, hi - window) if window else 0
        else:
            if int(total[b]) <= int(start[b]):
                continue
            hi = int(total[b])
            lo = max(0, int(start[b]) - window + 1) if window else 0
        if hi > lo and (lo < lo_key or hi > hi_key):
            bad.append(f"row {b} attends keys [{lo}, {hi}), the walk "
                       f"covers [{lo_key}, {hi_key})")
    return bad


def _page_walk(entry: Entry, call: Call, walk: Walk) -> List[str]:
    vals = _values(entry, call.args)
    table = vals.get(walk.table)
    pools = [vals.get(p) for p in walk.pools]
    rows = [vals.get(r) for r in walk.rows]
    if not all(isinstance(t, TensorArg) and t.values is not None
               for t in [table] + rows) \
            or not all(isinstance(p, TensorArg) and p.shape for p in pools):
        return [f"{entry.name}: the walk's operands were not captured"]
    kw = dict(lens=rows[0].values) if len(rows) == 1 else \
        dict(start=rows[0].values, total=rows[1].values)
    return page_walk_problems(
        table.values, min(p.shape[0] for p in pools), int(vals["ps"]),
        int(vals["pages_start"]), int(vals["pages_end"]),
        int(vals["window"]), rows=call.rows, **kw)


def audit(calls: Sequence[Call], entries: Dict[str, Entry],
          rules: Optional[frozenset] = None, layouts: Optional[Dict] = None,
          walks: Optional[Dict] = None) -> List[Finding]:
    """``kernel-abi``, ``kernel-extent`` and ``kernel-page-walk`` over the
    captured ``calls``."""
    rules = RULES if rules is None else frozenset(rules)
    layouts = LAYOUTS if layouts is None else layouts
    walks = PAGE_WALKS if walks is None else walks
    queries = {(c.entry, tuple(int(a) for a in c.args)): c.result
               for c in calls if c.kind == "query"}
    out: List[Finding] = []
    for i, call in enumerate(calls):
        entry = entries.get(call.entry)
        tag = f"{call.family}[{call.mode}] {call.kind} {i}: "

        def emit(rule: str, msg: str, e=entry) -> None:
            if rule in rules:
                out.append(Finding(
                    rule=rule, path=e.path if e else f"csrc/{call.lib}.cu",
                    line=e.line if e else 0, symbol=call.entry,
                    message=tag + msg))

        if entry is None or entry.lib != call.lib:
            emit("kernel-abi", f"no extern \"C\" {call.entry} in "
                 f"csrc/{call.lib}.cu")
            continue
        abi = _abi(entry, call)
        for msg in abi:
            emit("kernel-abi", msg)
        if abi or call.kind != "launch":
            continue
        walk = walks.get(call.entry)
        if call.entry in layouts:
            for msg in _extent(entry, call, layouts[call.entry], walk,
                               queries, entries):
                emit("kernel-extent", msg)
        if walk is not None and "kernel-page-walk" in rules:
            for msg in _page_walk(entry, call, walk):
                emit("kernel-page-walk", msg)
    return out


# ------------------------------------------------------- static-arg pairs
def _public_fns(tree: ast.Module) -> List[ast.FunctionDef]:
    return [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and not n.name.startswith("_")]


def _fn_params(fn: ast.FunctionDef) -> set:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def _body_names(fn: ast.FunctionDef) -> set:
    return {sub.id for node in fn.body for sub in ast.walk(node)
            if isinstance(sub, ast.Name)}


def check_static_args(family: str, family_dir: Path,
                      rules: Optional[frozenset] = None) -> List[Finding]:
    """``kernel-static-args``: each of ``AUDITED_STATIC_ARGS`` that a
    public ``ops.py`` function takes, a public ``ref.py`` function takes
    and reads."""
    rules = RULES if rules is None else frozenset(rules)
    out: List[Finding] = []
    ops_p, ref_p = family_dir / "ops.py", family_dir / "ref.py"
    if "kernel-static-args" not in rules or not ops_p.is_file():
        return out
    taken = set().union(*[_fn_params(f) for f in
                          _public_fns(ast.parse(ops_p.read_text()))])
    audit_names = sorted(taken & set(AUDITED_STATIC_ARGS))
    if not audit_names:
        return out

    def emit(msg: str) -> None:
        out.append(Finding(rule="kernel-static-args",
                           path=f"kernels/{family}/ref.py", line=0,
                           symbol=family, message=msg))

    if not ref_p.is_file():
        emit("ref.py missing for a family whose wrapper threads "
             f"{audit_names}")
        return out
    fns = _public_fns(ast.parse(ref_p.read_text()))
    for name in audit_names:
        if not any(name in _fn_params(f) for f in fns):
            emit(f"{name!r}, which the wrapper takes, is taken by no "
                 "public ref.py function")
        elif not any(name in _fn_params(f) and name in _body_names(f)
                     for f in fns):
            emit(f"{name!r} is taken but never read by the plain "
                 "version's body")
    return out


# ------------------------------------------------------------------ run
def run(root: Path, rules: Optional[frozenset] = None) -> List[Finding]:
    """The static audit of the tree at ``root`` (``src/repro_torch``, or a
    fixture tree with ``kernels/`` and ``csrc/``): the layouts against the
    sources, every registered family's probes captured on the ``meta``
    device, and coverage."""
    rules = RULES if rules is None else frozenset(rules)
    root = Path(root)
    entries = read_entries(root / "csrc")
    out = check_layouts(entries, rules=rules)
    reached = set()

    def uncovered(path: str, symbol: str, msg: str) -> None:
        if "kernel-uncovered" in rules:
            out.append(Finding(rule="kernel-uncovered", path=path, line=0,
                               symbol=symbol, message=msg))

    kernels = root / "kernels"
    families = sorted(d.name for d in kernels.iterdir()
                      if d.is_dir() and (d / "ops.py").is_file()) \
        if kernels.is_dir() else []
    for family in families:
        out.extend(check_static_args(family, kernels / family, rules))
        if family not in PROBES:
            uncovered(f"kernels/{family}/ops.py", family,
                      "no probe registered in analysis.kernel_check.PROBES "
                      "— a new kernel family must buy into the launch "
                      "audit")
            continue
        with capture(modules=family_modules([family])) as rec:
            for mode in probe_modes(families=[family])[family]:
                rec.mode = mode.name
                mode.run()
        if not any(c.kind == "launch" for c in rec.calls):
            uncovered(f"kernels/{family}/ops.py", family,
                      "the probe captured no launch")
        reached.update(c.entry for c in rec.calls)
        out.extend(audit(rec.calls, entries, rules))
    for name, e in sorted(entries.items()):
        if name not in reached:
            uncovered(e.path, name, "no probe reaches this extern \"C\" "
                      "entry")
    return out

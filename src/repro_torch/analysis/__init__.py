"""Static analysis of the port: the serving invariants and the kernel
launches, machine-checked.

The port's correctness rests on the same hand-kept invariants as the JAX
package's — a single refcount-aware page release choke point, a declared
slot-lifecycle FSM, a device-async serving step — and on one of its own:
every ``ctypes`` call of a CUDA kernel's C entry must match the entry's
signature and stay inside its operands. Four passes, run as
``python -m repro_torch.analysis`` (non-zero exit on findings):

* ``kernel_check`` — parses every ``extern "C"`` entry of ``csrc/*.cu``,
  captures each ``kernels/*/`` wrapper's calls through every launch mode
  (probe inputs on the ``meta`` device; live on the card), and audits
  them: argument types and count against the signature, every pointer
  operand's reach against its tensor's storage, the paged kernels' page
  walks against their callers' promise, and the ops/ref pairs' threaded
  compile-time arguments. The counterpart of ``repro.analysis.
  pallas_check``.
* ``fsm_check`` — AST-extracts every request/slot state transition from
  ``serving/{scheduler,engine,pool}.py`` and verifies it against the
  declared table (``scheduler.TRANSITIONS`` + the port's ``fsm_spec``).
* ``trace_lint`` — the hot-path lint: host syncs in ``serving/`` and
  ``models/``, wall-clock stamps in serving paths, mutable defaults.
* ``page_ledger`` — proves every page-freeing call site in
  ``serving/{cache,engine,pool,prefix}.py`` routes through the
  refcount-aware ``PagedKVCache._release``.

Intentional exceptions live in ``allowlist.ALLOWLIST``; every entry must
carry a written reason and must still match a live finding — stale or
reasonless entries fail the run (exit 2). Nothing here imports JAX or the
JAX package.
"""
from __future__ import annotations

from .report import AllowEntry, Finding  # noqa: F401

PASSES = ("kernel", "fsm", "trace", "ledger")

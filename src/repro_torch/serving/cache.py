"""Paged serving state: a block-pool KV allocator over a shared device page
pool (the port of ``repro.serving.cache.PagedKVCache``), and the per-slot
recurrent-state rows of SSM stacks (``RecurrentStatePool``).

Dense serving gives every request a (max_seq, K, Dh) slab per layer; the
paged cache carves the device KV buffers into fixed-size pages
(``models.attention.init_paged_kv_cache``) and hands each serving slot just
the pages its context occupies. The allocator is host-side bookkeeping
(free list, page table, per-slot lengths) in numpy; each step reads copies
of the table as device tensors.

Page 0 is reserved: inactive slots' writes and fully masked reads land
there, so the step never needs a branch on slot liveness.

Pages may also be held outside any slot (``hold_pages``: the fault
harness's page pressure, a co-tenant, a shrinking quota) until
``release_pages`` gives them back; held pages count as in use.

The reference's shared-prefix tree (refcounted pages, copy-on-write) comes
with the prefix-sharing slice; here every page has exactly one owner, a
slot or an external hold, or is free.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class CacheStats:
    num_pages: int = 0            # allocatable pages (excl. reserved page 0)
    page_size: int = 0
    pages_in_use: int = 0
    high_water_pages: int = 0     # max pages_in_use over the session
    allocs: int = 0               # slot admissions
    appends: int = 0              # decode-time page extensions
    oom_denials: int = 0          # admissions/extensions refused for space


class RecurrentStatePool:
    """Per-slot recurrent-state slabs for SSM serving.

    ``bundle.init_recurrent_state(n_slots + 1)`` builds the device slabs
    (``self.state``, each with a leading row axis), which every prefill
    chunk and decode step updates in place.

    Row convention: row 0 is the reserved scratch row (packed-prefill
    padding rows gather and scatter it, so the step needs no liveness
    branch) and slot ``s`` owns row ``s + 1`` (``rows``). Slot reuse needs
    no host-side reset: a prompt's first chunk re-enters its row from zero
    state, and a decode step leaves the rows of inactive slots as they
    are.
    """

    def __init__(self, bundle, n_slots: int, device="cuda"):
        if bundle.init_recurrent_state is None:
            raise ValueError(f"{bundle.cfg.name}: architecture keeps no "
                             "recurrent serving state")
        self.n_slots = n_slots
        self.state = bundle.init_recurrent_state(n_slots + 1, device=device)

    def rows(self, slots) -> np.ndarray:
        """State-pool row ids for ``slots`` (np.int32); pad with 0 (the
        scratch row) for packed-batch padding rows."""
        return np.asarray(slots, np.int32) + 1

    @property
    def state_bytes(self) -> int:
        """Device bytes held by the state slabs (all rows, scratch
        included): constant for the engine's lifetime, the recurrent
        counterpart of the KV pool's capacity."""
        return sum(t.numel() * t.element_size() for t in self.state.values())


class PagedKVCache:
    """Block-pool KV cache for one model's serving slots.

    ``bundle.init_paged_cache`` builds the device pool (``self.pool``,
    updated in place by every step); this class owns the host-side page
    table (n_slots, max_pages_per_slot), per-slot lengths and the free
    list.
    """

    def __init__(self, bundle, n_slots: int, num_pages: int, page_size: int,
                 max_pages_per_slot: int, prefix_pages: int = 0,
                 device="cuda"):
        if prefix_pages:
            raise NotImplementedError(
                "prefix_pages > 0: shared-prefix KV reuse is not ported yet "
                "(it comes with the prefix-sharing slice)")
        self.pool = bundle.init_paged_cache(num_pages, page_size,
                                            device=device)
        self.n_slots = n_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.page_table = np.zeros((n_slots, max_pages_per_slot), np.int32)
        self.seq_lens = np.zeros((n_slots,), np.int32)
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> 1, 2, ...
        self._owned: dict[int, list[int]] = {s: [] for s in range(n_slots)}
        self.held_pages = 0       # pages taken out by hold_pages
        self.stats = CacheStats(num_pages=num_pages - 1, page_size=page_size)

    # ------------------------------------------------------------- allocation
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens (ceil division by
        ``page_size``)."""
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int, reserve: int = 0) -> bool:
        """Can a fresh request of ``n_tokens`` be admitted now? ``reserve``
        discounts pages promised to slots still mid-prefill (chunked
        admission allocates incrementally, so their remaining prompt pages
        are not yet in ``pages_in_use``)."""
        n = self.pages_for(max(n_tokens, 1))
        return n <= len(self._free) - reserve and n <= self.max_pages_per_slot

    def _take(self, n: int):
        """Pop ``n`` fresh pages off the free list, or None (nothing
        taken) when the pool can't cover ``n``."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def owned_pages(self, slot: int) -> int:
        """Pages currently allocated to ``slot`` (0 for a free slot)."""
        return len(self._owned[slot])

    @property
    def free_pages(self) -> int:
        """Pages currently on the free list."""
        return len(self._free)

    def extend_slot(self, slot: int, n_new: int):
        """Extend ``slot`` by ``n_new`` tokens (one chunked-prefill step):
        allocate whatever pages are needed to cover ``seq_lens + n_new`` and
        advance ``seq_lens``. Works on an empty slot too (first chunk).
        Returns the newly allocated page ids (possibly empty) or None if the
        pool / the slot's page cap can't satisfy the extension — in which
        case nothing is allocated and ``seq_lens`` is unchanged."""
        owned = self._owned[slot]
        need = self.pages_for(int(self.seq_lens[slot]) + n_new)
        fresh = need - len(owned)
        pages = self._take(fresh) if need <= self.max_pages_per_slot else None
        if pages is None:
            self.stats.oom_denials += 1
            return None
        self.page_table[slot, len(owned):need] = pages
        if not owned:
            self.stats.allocs += 1
        else:
            self.stats.appends += fresh
        owned.extend(pages)
        self.seq_lens[slot] += n_new
        self._mark_usage()
        return np.asarray(pages, np.int32)

    def extend_slots(self, slots, n_news):
        """Batched ``extend_slot`` for packed multi-slot prefill: each
        (slot, n_new) extension is attempted independently, in order — a
        row the pool can't satisfy gets None while the rest proceed."""
        return [self.extend_slot(s, n) for s, n in zip(slots, n_news)]

    def ensure_append(self, slot: int, reserve: int = 0) -> bool:
        """Guarantee room for one more token in ``slot`` (the next decode
        step's write). Allocates a fresh page at a page boundary. Returns
        False when the pool is exhausted or the slot hit its page cap — the
        engine then skips the slot this step. ``reserve`` discounts pages
        promised to mid-prefill slots."""
        used = int(self.seq_lens[slot])
        owned = self._owned[slot]
        if used < len(owned) * self.page_size:
            return True
        if len(owned) >= self.max_pages_per_slot \
                or len(self._free) - reserve < 1:
            self.stats.oom_denials += 1
            return False
        page = self._take(1)[0]
        self.page_table[slot, len(owned)] = page
        owned.append(page)
        self.stats.appends += 1
        self._mark_usage()
        return True

    def free_slot(self, slot: int):
        """Return the slot's pages to the free list (in the reference's
        order, so both allocators hand out the same page ids)."""
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self.page_table[slot, :] = 0
        self.seq_lens[slot] = 0
        self._mark_usage()

    # ------------------------------------------------------- external holds
    def hold_pages(self, n: int) -> np.ndarray:
        """Take up to ``n`` free pages out of circulation (page pressure).
        Held pages count as in use and shrink every admission and extension
        decision until ``release_pages`` returns them; the engine waits out
        a stall while pages are held instead of preempting or raising.
        Returns the held page ids."""
        take = [self._free.pop() for _ in range(min(n, len(self._free)))]
        self.held_pages += len(take)
        self._mark_usage()
        return np.asarray(take, np.int32)

    def release_pages(self, pages) -> None:
        """Return pages taken by ``hold_pages`` to the free list."""
        pages = [int(p) for p in np.asarray(pages).reshape(-1)]
        if len(pages) > self.held_pages:
            raise ValueError(f"releasing {len(pages)} pages but only "
                             f"{self.held_pages} are held")
        self._free.extend(reversed(pages))
        self.held_pages -= len(pages)
        self._mark_usage()

    def check_pages(self) -> list:
        """Page audit; returns human-readable violations (empty =
        consistent): no page both free and owned, none owned twice, and
        free + held + owned pages make the whole pool."""
        bad: list = []
        owned = [p for pages in self._owned.values() for p in pages]
        if len(set(owned)) != len(owned):
            bad.append("a page is owned by two slots")
        if set(owned) & set(self._free):
            bad.append("an owned page is on the free list")
        if len(set(self._free)) != len(self._free):
            bad.append("a page is on the free list twice")
        total = len(self._free) + self.held_pages + len(owned)
        if total != self.num_pages - 1:
            bad.append(f"free {len(self._free)} + held {self.held_pages} + "
                       f"owned {len(owned)} pages != the pool's "
                       f"{self.num_pages - 1}")
        return bad

    # ------------------------------------------------------------------ views
    def device_tables(self, device):
        """(page_table, seq_lens) as int32 tensors on ``device``.

        Copies, not views: ``torch.from_numpy`` would alias the numpy
        buffers, which the allocator mutates while a step dispatched on the
        device may still be reading them."""
        return (torch.tensor(self.page_table, device=device),
                torch.tensor(self.seq_lens, device=device))

    # ------------------------------------------------------------------ stats
    def _mark_usage(self):
        in_use = self.stats.num_pages - len(self._free)
        self.stats.pages_in_use = in_use
        self.stats.high_water_pages = max(self.stats.high_water_pages, in_use)

    @property
    def fragmentation(self) -> float:
        """Fraction of allocated token slots not holding a token (the tail
        waste of partly filled last pages)."""
        alloc = sum(len(p) for p in self._owned.values()) * self.page_size
        used = int(self.seq_lens.sum())
        return (alloc - used) / alloc if alloc else 0.0

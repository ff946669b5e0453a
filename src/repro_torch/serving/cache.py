"""Paged serving state: a block-pool KV allocator over a shared device page
pool (the port of ``repro.serving.cache.PagedKVCache``), and the per-slot
recurrent-state rows of SSM and hybrid stacks (``RecurrentStatePool``).

Dense serving gives every request a (max_seq, K, Dh) slab per layer; the
paged cache carves the device KV buffers into fixed-size pages
(``models.attention.init_paged_kv_cache``) and hands each serving slot just
the pages its context occupies. The allocator is host-side bookkeeping
(free list, page table, per-slot lengths) in numpy; each step reads copies
of the table as device tensors.

Page 0 is reserved: inactive slots' writes and fully masked reads land
there, so the step never needs a branch on slot liveness.

Pages are refcounted (``ref``): a private page has count 1, its slot.
Shared-prefix serving (``serving.prefix.PrefixTree``, built with
``prefix_pages > 0``) raises counts: one per slot mapping the page
read-only, plus one while the tree holds it. Every free path (retirement,
preemption, speculative rollback through ``truncate_slot``, deadline
cancellation, tree eviction) goes through the one refcount-aware
``_release``, and a page rejoins the free list only when its last
reference drops. A slot's first write into a page it does not own alone
is a copy-on-write split (``cow_page``; the engine copies the page's K/V
on the device), and an allocation the free list cannot cover evicts
unreferenced tree pages (LRU) before it reports a stall.

Pages may also be held outside any slot (``hold_pages``: the fault
harness's page pressure, a co-tenant, a shrinking quota) until
``release_pages`` gives them back; held pages count as in use, and come
only from the free list, never from the tree.

``repro_torch.analysis.page_ledger`` checks the single free path: any
other write to the free list or a refcount, in this module, the engine,
the pool or the prefix tree, is a finding, except the two hold hooks,
allowlisted with their reasons (``analysis/allowlist.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .prefix import PrefixTree


@dataclasses.dataclass
class CacheStats:
    num_pages: int = 0            # allocatable pages (excl. reserved page 0)
    page_size: int = 0
    pages_in_use: int = 0
    high_water_pages: int = 0     # max pages_in_use over the session
    allocs: int = 0               # slot admissions
    appends: int = 0              # decode-time page extensions
    oom_denials: int = 0          # admissions/extensions refused for space
    truncations: int = 0          # pages released by truncate_slot (rollback)
    cow_splits: int = 0           # copy-on-write page copies performed


class RecurrentStatePool:
    """Per-slot recurrent-state slabs for SSM and hybrid serving.

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
        # per-page reference counts: 0 = free or held, 1 = owned by one
        # slot (or resident in the tree alone), > 1 = shared
        self.ref = np.zeros((num_pages,), np.int32)
        # the shared-prefix tree; prefix_pages caps its resident pages, 0
        # disables sharing
        self.prefix = PrefixTree(self, prefix_pages) if prefix_pages else None
        self.stats = CacheStats(num_pages=num_pages - 1, page_size=page_size)

    # ------------------------------------------------------------- allocation
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens (ceil division by
        ``page_size``)."""
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int, reserve: int = 0,
                  hit_pages: int = 0) -> bool:
        """Can a fresh request of ``n_tokens`` be admitted now? ``reserve``
        discounts pages promised to slots still mid-prefill (chunked
        admission allocates incrementally, so their remaining prompt pages
        are not yet in ``pages_in_use``); ``hit_pages`` discounts full
        pages a prefix-tree walk would map shared instead of allocating.
        Evictable tree pages count as free: allocation reclaims them."""
        n = self.pages_for(max(n_tokens, 1))
        avail = len(self._free) - reserve
        if self.prefix is not None:
            avail += self.prefix.evictable()
        return n - hit_pages <= avail and n <= self.max_pages_per_slot

    def _take(self, n: int):
        """Pop ``n`` fresh pages off the free list at refcount 1, evicting
        unreferenced tree pages (LRU) to cover a shortfall, or None
        (nothing taken) when even that cannot cover ``n``."""
        if n > len(self._free) and self.prefix is not None:
            self.prefix.evict(n - len(self._free))
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.ref[p] = 1
        return pages

    def _release(self, pages) -> list:
        """The one refcount-aware free path: each page loses one reference
        and rejoins the free list (in the reference's order) only when its
        last one drops. Returns the pages freed."""
        freed = []
        for p in pages:
            p = int(p)
            r = int(self.ref[p]) - 1
            if r < 0:
                raise AssertionError(f"page {p}: released below zero "
                                     "references — double free")
            self.ref[p] = r
            if r == 0:
                freed.append(p)
        self._free.extend(reversed(freed))
        return freed

    def owned_pages(self, slot: int) -> int:
        """Pages currently allocated to ``slot`` (0 for a free slot)."""
        return len(self._owned[slot])

    @property
    def free_pages(self) -> int:
        """Pages currently on the free list."""
        return len(self._free)

    def map_shared(self, slot: int, pages, n_tokens: int) -> None:
        """Map resident (prefix-tree) pages read-only into an empty slot:
        each gains a reference, the slot's table points at them and
        ``seq_lens`` jumps to ``n_tokens``, with no prefill chunk run. The
        last page may be matched in part (a mid-page fork); the slot's
        first write into a page it does not own alone must ``cow_page``
        first."""
        assert not self._owned[slot], f"slot {slot} already owns pages"
        pages = [int(p) for p in pages]
        assert len(pages) <= self.max_pages_per_slot
        for i, p in enumerate(pages):
            self.ref[p] += 1
            self.page_table[slot, i] = p
        self.page_table[slot, len(pages):] = 0
        self._owned[slot] = pages
        self.seq_lens[slot] = n_tokens
        self.stats.allocs += 1
        self._mark_usage()

    def page_is_shared(self, slot: int, pos: int) -> bool:
        """Is the page holding position ``pos`` of ``slot`` referenced
        beyond this slot? Writing it needs ``cow_page`` first."""
        idx = pos // self.page_size
        owned = self._owned[slot]
        return idx < len(owned) and int(self.ref[owned[idx]]) > 1

    def cow_page(self, slot: int, pos: int):
        """Copy-on-write split of the shared page holding ``pos``: a
        private page replaces it in the slot's table and the shared one
        loses this slot's reference. The caller copies the page's K/V src
        -> dst on the device before any write lands. Returns (src, dst),
        or None when no page is free even after tree eviction (nothing
        changed: a stall)."""
        idx = pos // self.page_size
        src = self._owned[slot][idx]
        assert int(self.ref[src]) > 1, f"page {src} is not shared"
        got = self._take(1)
        if got is None:
            self.stats.oom_denials += 1
            return None
        dst = got[0]
        self._owned[slot][idx] = dst
        self.page_table[slot, idx] = dst
        self._release([src])
        self.stats.cow_splits += 1
        self._mark_usage()
        return src, dst

    def prefix_publish(self, slot: int, tokens, upto: int) -> int:
        """Publish ``slot``'s completed full pages covering
        ``tokens[:upto]`` into the tree (deduplicated against resident
        prefixes): after each prefill chunk lands, and just before a
        retirement, preemption or escalation frees the slot. Returns the
        pages inserted."""
        if self.prefix is None:
            return 0
        n_full = upto // self.page_size
        if n_full == 0:
            return 0
        return self.prefix.publish(tokens[:n_full * self.page_size],
                                   self._owned[slot][:n_full])

    def drop_prefix(self) -> None:
        """Detach the tree, releasing its references (pages slots still map
        survive until those slots free)."""
        if self.prefix is not None:
            self.prefix.clear()
            self.prefix = None
            self._mark_usage()

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

    def truncate_slot(self, slot: int, n_tokens: int):
        """Roll ``slot`` back to ``n_tokens`` resident tokens, the inverse
        of ``extend_slot`` (speculative rollback): ``seq_lens`` rewinds and
        the pages past ``pages_for(n_tokens)`` lose this slot's reference
        (their table entries return to the scratch page 0). A page another
        holder still references (the tree, a sibling slot) stays resident.
        A no-op at or above the page boundary ``n_tokens`` needs. Returns
        the tail page ids released from the slot (np.int32)."""
        cur = int(self.seq_lens[slot])
        if not 0 <= n_tokens <= cur:
            raise ValueError(f"truncate_slot(slot={slot}, "
                             f"n_tokens={n_tokens}): slot holds {cur} tokens"
                             f" — truncation can only rewind, never extend")
        owned = self._owned[slot]
        keep = self.pages_for(n_tokens)
        tail = owned[keep:]
        self._release(tail)
        del owned[keep:]
        self.page_table[slot, keep:] = 0
        self.seq_lens[slot] = n_tokens
        self.stats.truncations += len(tail)
        self._mark_usage()
        return np.asarray(tail, np.int32)

    def ensure_append(self, slot: int, reserve: int = 0) -> bool:
        """Guarantee room for one more token in ``slot`` (the next decode
        step's write). Allocates a fresh page at a page boundary. Returns
        False when the pool (evictable tree pages included) is exhausted
        or the slot hit its page cap — the engine then skips the slot this
        step. ``reserve`` discounts pages promised to mid-prefill slots."""
        used = int(self.seq_lens[slot])
        owned = self._owned[slot]
        if used < len(owned) * self.page_size:
            return True
        avail = len(self._free)
        if self.prefix is not None:
            avail += self.prefix.evictable()
        if len(owned) >= self.max_pages_per_slot or avail - reserve < 1:
            self.stats.oom_denials += 1
            return False
        page = self._take(1)[0]
        self.page_table[slot, len(owned)] = page
        owned.append(page)
        self.stats.appends += 1
        self._mark_usage()
        return True

    def free_slot(self, slot: int):
        """Release the slot's pages (refcount-aware: shared pages stay for
        the tree and the sibling slots still mapping them)."""
        self._release(self._owned[slot])
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
        consistent): no slot maps a page twice, no live page (mapped by a
        slot or resident in the tree) is on the free list, no page is on
        it twice, and free + held + live pages make the whole pool."""
        bad: list = []
        if any(len(set(pages)) != len(pages)
               for pages in self._owned.values()):
            bad.append("a slot maps a page twice")
        live = {p for pages in self._owned.values() for p in pages}
        if self.prefix is not None:
            live |= set(self.prefix.resident_page_ids())
        if live & set(self._free):
            bad.append("a live page is on the free list")
        if len(set(self._free)) != len(self._free):
            bad.append("a page is on the free list twice")
        total = len(self._free) + self.held_pages + len(live)
        if total != self.num_pages - 1:
            bad.append(f"free {len(self._free)} + held {self.held_pages} + "
                       f"live {len(live)} pages != the pool's "
                       f"{self.num_pages - 1}")
        return bad

    def check_refcounts(self) -> list:
        """Reference audit; returns human-readable violations (empty =
        consistent): each page's count equals the slots mapping it plus
        one if the tree holds it, no page with references is on the free
        list, and the zero-reference pages off the free list are exactly
        the held ones."""
        bad: list = []
        expect = np.zeros((self.num_pages,), np.int64)
        for owned in self._owned.values():
            for p in owned:
                expect[p] += 1
        if self.prefix is not None:
            for p in self.prefix.resident_page_ids():
                expect[p] += 1
        free_set = set(self._free)
        unaccounted = 0
        for p in range(1, self.num_pages):
            r = int(self.ref[p])
            if r != int(expect[p]):
                bad.append(f"page {p}: refcount {r} but {int(expect[p])} "
                           "live references (slots + prefix tree)")
            if r > 0 and p in free_set:
                bad.append(f"page {p}: on the free list with refcount {r}")
            if r == 0 and p not in free_set:
                unaccounted += 1
        if unaccounted != self.held_pages:
            bad.append(f"{unaccounted} zero-reference pages off the free "
                       f"list but {self.held_pages} held externally")
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

"""Shared-prefix KV reuse: a page-granular radix tree over token ids (the
port of ``repro.serving.prefix``, host-side Python like the reference).

Production traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn chat histories, best-of-N / agent fan-out —
yet a plain paged engine re-prefills every admission's full prompt into
private pages. ``PrefixTree`` keys *completed full pages* of KV by the
exact token ids whose K/V they hold: admission walks the tree with the
prompt, maps the longest cached prefix's pages read-only into the slot's
page table (their prefill chunks never launch — TTFT drops to the
fork-point prefill), and allocates fresh pages only past the fork. Slots
publish their completed full pages back into the tree as prefill advances
and when they retire or are preempted, so a multi-turn session's next
turn (or a preempted session's resume) finds its whole history resident.

Sharing is enforced by per-page *refcounts* owned by ``PagedKVCache``
(serving.cache): a page's count is the number of slots mapping it plus one
if the tree holds it, and every free path decrements through the cache's
single refcount-aware release. Two consequences:

* **Copy-on-write tail pages.** The walk may fork *inside* a cached page
  (the new prompt shares only the first k < page_size tokens of it). The
  page is still mapped — those k tokens' prefill is skipped — but the
  slot's first write into it triggers a copy (``PagedKVCache.cow_page`` +
  a device page copy), so the cached K/V is never clobbered.
* **LRU eviction under pressure.** A tree page referenced by no slot
  (refcount 1) is reclaimable: when the free list can't satisfy an
  allocation, the cache evicts least-recently-touched evictable leaves
  *before* the engine's stall ladder (wait / preempt / deadlock) ever
  sees the shortage, and ``max_pages`` caps the tree's resident footprint
  outright. Pages a slot still maps are never evicted.

Node granularity is one full page: a node's ``key`` is the page_size-token
tuple stored in its page, and a root-to-node path spells a prompt prefix.
Partial pages are never *inserted* (their K/V is still being written), only
partially *matched* (the COW case above). Determinism: the walk is a pure
function of the tree contents and the query tokens — ties on a partial
tail match break toward the longest match, then insertion order — so
serving stays replayable and greedy-exact vs ``prefix_cache=0``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class PrefixStats:
    lookups: int = 0          # admission walks
    hits: int = 0             # walks that matched >= 1 token
    misses: int = 0           # walks that matched nothing
    hit_pages: int = 0        # pages mapped read-only by walks
    hit_tokens: int = 0       # prompt tokens whose prefill was skipped
    published_pages: int = 0  # full pages inserted (deduped re-publishes
                              # of an already-resident prefix don't count)
    evicted_pages: int = 0    # tree pages released (LRU pressure or cap)

    @property
    def hit_rate(self) -> float:
        """Fraction of admission walks that found any cached prefix."""
        return self.hits / self.lookups if self.lookups else 0.0


class _Node:
    """One cached full page: ``key`` is the page_size token ids whose K/V
    ``page`` holds; the root-to-here path spells the prompt prefix."""
    __slots__ = ("key", "page", "children", "parent", "stamp")

    def __init__(self, key: tuple, page: int, parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict = {}   # child key tuple -> _Node
        self.stamp = 0             # LRU tick of the last walk through here


class PrefixTree:
    """Page-granular radix tree over token ids, bound to one
    ``PagedKVCache`` (per tier: each tier's pool shares only with itself —
    pages are meaningless across models). The tree holds one reference on
    every resident page; all reference arithmetic goes through the cache's
    release path, never a raw free-list append."""

    def __init__(self, cache, max_pages: int):
        if max_pages < 1:
            raise ValueError(f"max_pages={max_pages}: a prefix tree needs "
                             "room for at least one resident page")
        self.cache = cache
        self.max_pages = max_pages
        self.root = _Node((), -1, None)
        self.resident = 0          # pages the tree currently references
        self._tick = 0
        self.stats = PrefixStats()

    # ---------------------------------------------------------------- walks
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.stamp = self._tick

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: full-page exact matches
        down the tree, then at most one partial match *into* a child page
        (the copy-on-write tail — its first k tokens agree, the slot's
        first write there copies the page). Returns ``(pages, matched)``
        where ``pages`` map read-only into table entries 0..len-1 and
        ``matched`` tokens of prefill are skipped. Touches the matched
        path's LRU stamps. The caller caps ``tokens`` (the engine always
        recomputes the final prompt token — its logits sample the first
        output token)."""
        ps = self.cache.page_size
        toks = [int(t) for t in tokens]
        node, pages, i = self.root, [], 0
        while i + ps <= len(toks):
            child = node.children.get(tuple(toks[i:i + ps]))
            if child is None:
                break
            self._touch(child)
            pages.append(child.page)
            node, i = child, i + ps
        rem = toks[i:]
        best, best_len = None, 0
        for child in node.children.values():
            k = 0
            while k < len(rem) and k < len(child.key) \
                    and child.key[k] == rem[k]:
                k += 1
            if k > best_len:
                best, best_len = child, k
        if best is not None:
            self._touch(best)
            pages.append(best.page)
            i += best_len
        self.stats.lookups += 1
        if i:
            self.stats.hits += 1
            self.stats.hit_pages += len(pages)
            self.stats.hit_tokens += i
        else:
            self.stats.misses += 1
        return pages, i

    def peek_pages(self, tokens) -> int:
        """Full-page matches for ``tokens`` without touching LRU stamps or
        stats — the admission-capacity discount. Partial tail matches
        don't count: a COW split consumes a fresh page anyway."""
        ps = self.cache.page_size
        toks = [int(t) for t in tokens]
        node, i = self.root, 0
        while i + ps <= len(toks):
            child = node.children.get(tuple(toks[i:i + ps]))
            if child is None:
                break
            node, i = child, i + ps
        return i // ps

    # ------------------------------------------------------------ publishing
    def publish(self, tokens, pages) -> int:
        """Insert completed full pages: ``pages[i]`` holds the K/V of
        ``tokens[i*ps:(i+1)*ps]``. Already-resident prefixes dedup (the
        first publisher's page stays; a duplicate computed independently is
        simply not inserted — it frees with its slot). Each newly inserted
        page gains one tree reference. Returns pages inserted; evicts LRU
        leaves past ``max_pages`` (best effort — pinned pages may hold the
        tree over cap until their slots release)."""
        ps = self.cache.page_size
        node, new = self.root, 0
        for i, page in enumerate(pages):
            key = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(page), node)
                node.children[key] = child
                self.cache.ref[int(page)] += 1
                self.resident += 1
                new += 1
            self._touch(child)
            node = child
        self.stats.published_pages += new
        if self.resident > self.max_pages:
            self.evict(self.resident - self.max_pages)
        return new

    # -------------------------------------------------------------- eviction
    def _evictable_leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children \
                    and int(self.cache.ref[n.page]) == 1:
                out.append(n)
        return out

    def evictable(self) -> int:
        """Pages reclaimable by cascaded leaf eviction right now: nodes
        whose whole subtree is unreferenced by any slot. Interior pages
        above a pinned descendant don't count — evicting them would orphan
        a reachable prefix."""
        def walk(node: _Node) -> Tuple[int, bool]:
            cnt, full = 0, True
            for c in node.children.values():
                c_cnt, c_full = walk(c)
                cnt += c_cnt
                full = full and c_full
            if node is self.root:
                return cnt, False
            if full and int(self.cache.ref[node.page]) == 1:
                return cnt + 1, True
            return cnt, False
        return walk(self.root)[0]

    def evict(self, n_pages: int) -> int:
        """Release up to ``n_pages`` least-recently-touched evictable
        leaves (a freed leaf may expose its parent next round). Pages still
        mapped by a slot (refcount > 1) are never victims. Returns pages
        actually freed — the cache calls this ahead of the engine's stall
        ladder, so tree memory yields to live traffic before anyone waits,
        preempts, or deadlocks."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.stamp)
            del victim.parent.children[victim.key]
            self.cache._release([victim.page])
            self.resident -= 1
            freed += 1
            self.stats.evicted_pages += 1
        if freed:
            self.cache._mark_usage()
        return freed

    def clear(self) -> int:
        """Drop every tree reference (pages a slot still maps survive until
        that slot releases them). Returns pages released."""
        n, stack = 0, list(self.root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            self.cache._release([nd.page])
            n += 1
        self.root.children = {}
        self.resident = 0
        if n:
            self.cache._mark_usage()
        return n

    # ---------------------------------------------------------------- audits
    def resident_page_ids(self) -> List[int]:
        """Every page the tree currently references (refcount audits)."""
        out, stack = [], list(self.root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            out.append(nd.page)
        return out

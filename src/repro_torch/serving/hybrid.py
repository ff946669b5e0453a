"""Hybrid two-model serving — the paper's deployment artifact, as two-tier
facades (the port of ``repro.serving.hybrid``).

* ``HybridEngine`` (dense batch): score a batch with the router, partition
  it, serve each partition on its dense ``Engine``, join. The join is a
  batch barrier: the small model's results wait for the large model's
  partition. Kept for offline evaluation parity with the paper's tables.

* ``ContinuousHybridEngine`` (continuous paged): a facade over
  ``ContinuousPoolEngine`` with a two-tier ``ThresholdPolicy``: the router
  classifies each query once at admission, and the two continuous engines
  step independently, so the small stream never waits for the large one.

The reference's ``build_fused_hybrid_step`` (one XLA program over router
and both decoders, for the TPU mesh's dry run) is multi-device tooling and
is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.routing import CostMeter, HybridRouter, ThresholdPolicy
from repro_torch.data import tokenizer as tok
from .engine import ContinuousEngine, Engine
from .pool import ContinuousPoolEngine
from .scheduler import Request


@dataclasses.dataclass
class HybridResult:
    responses: np.ndarray     # (N, T)
    lengths: np.ndarray       # (N,)
    routed_small: np.ndarray  # (N,) bool
    scores: np.ndarray        # (N,)


class HybridEngine:
    """Dense-batch hybrid serving: partition, serve both, barrier-join."""

    def __init__(self, router: HybridRouter, small: Engine, large: Engine):
        self.router = router
        self.small = small
        self.large = large
        self.meter = CostMeter()
        self._serve_calls = 0

    def serve(self, query_tokens: np.ndarray, query_mask: np.ndarray,
              seed: int = 0) -> HybridResult:
        scores = self.router.scores(query_tokens, query_mask).cpu().numpy()
        to_small = scores >= self.router.threshold
        # the partitions may run different output budgets
        T = max(self.small.max_new_tokens, self.large.max_new_tokens)
        N = len(query_tokens)
        # PAD-filled: a partition with a smaller output budget than T
        # leaves a PAD tail, as every other serve path does
        responses = np.full((N, T), tok.PAD, np.int32)
        lengths = np.zeros((N,), np.int32)
        # distinct per-partition, per-call sampling seeds, mixed as the
        # reference mixes them (masked to 32 bits for SeedSequence)
        ss = np.random.SeedSequence([seed & 0xFFFFFFFF, self._serve_calls])
        seed_small, seed_large = (int(s) for s in ss.generate_state(2))
        self._serve_calls += 1
        if to_small.any():
            r, l = self.small.serve(query_tokens[to_small], seed_small)
            responses[to_small, :r.shape[1]], lengths[to_small] = r, l
        if (~to_small).any():
            r, l = self.large.serve(query_tokens[~to_small], seed_large)
            responses[~to_small, :r.shape[1]], lengths[~to_small] = r, l
        # §2.3 cost accounting charges the tokens actually generated
        self.meter.record(to_small, lengths)
        return HybridResult(responses, lengths, to_small, scores)


class ContinuousHybridEngine:
    """Two-tier facade over ``ContinuousPoolEngine``: admission-time routed
    serving over two independently stepping continuous engines."""

    def __init__(self, router: HybridRouter, small: ContinuousEngine,
                 large: ContinuousEngine):
        self.router = router
        self.small = small
        self.large = large
        self.pool = ContinuousPoolEngine(ThresholdPolicy(router),
                                         [("small", small), ("large", large)])
        # the paper-era meter is a live two-tier view of the pool's meter
        self.meter = CostMeter(self.pool.meter)

    def submit(self, query_tokens: np.ndarray, query_mask: np.ndarray
               ) -> Tuple[List[Request], np.ndarray, np.ndarray]:
        """Score and enqueue a batch of queries. Returns (requests,
        routed_small, scores); requests retire later via step()/run()."""
        reqs, tier_idx, scores = self.pool.submit(query_tokens, query_mask)
        return reqs, tier_idx == 0, scores

    def step(self) -> List[Request]:
        """Advance both engines by one step each, with no cross-engine
        join. Returns the requests retired this step."""
        return self.pool.step()

    def run(self) -> List[Request]:
        return self.pool.run()

    def serve(self, query_tokens: np.ndarray, query_mask: np.ndarray,
              seed: int = 0) -> HybridResult:
        """Batch API matching ``HybridEngine.serve``."""
        res = self.pool.serve(query_tokens, query_mask, seed)
        return HybridResult(res.responses, res.lengths, res.tier_idx == 0,
                            res.scores)

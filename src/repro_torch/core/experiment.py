"""End-to-end experiment pipeline (the port of ``repro.core.experiment``):
the reproduction's workhorse, on the card unless told otherwise.

Builds everything the paper's evaluation needs from scratch:
  1. synthetic instruction dataset (train/val/test),
  2. the tier LMs trained to different competence,
  3. sampled responses (n per query, temperature) from each,
  4. quality scores q(z) (edit-similarity),
  5. labels y_det / y_prob / y_trans(t*),
  6. routers r_det / r_prob / r_trans trained per §3,
  7. router scores on every split, ready for §4 metrics,
and the K-tier pool's routers and calibrated policies.

Model capacity pairs mirror the paper's three performance-gap regimes. The
datasets, the LMs' batches, the routers' epoch orders and each (tier,
split) sample stream's seed come from the same numpy calls as the
reference's; the weights' init and the sampled tokens come from
``torch.Generator`` streams, so sampled qualities agree with the
reference's in distribution, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict

import numpy as np

from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import (QueryDataset, generate_dataset,
                                    lm_training_arrays)
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import ModelBundle, build_model
from repro_torch.serving.generate import sample_responses
from repro_torch.training.trainer import TrainConfig, train_lm
from . import labels as labels_lib
from .quality import edit_similarity
from .router import RouterTrainConfig, score_dataset, train_router


def lm_config(name: str, n_layers: int, d_model: int, n_heads: int) -> ArchConfig:
    return ArchConfig(name=name, family="dense", n_layers=n_layers,
                      d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
                      d_ff=d_model * 4, vocab_size=tok.VOCAB_SIZE,
                      head_dim=max(8, d_model // n_heads),
                      vocab_pad_multiple=16, attn_chunk=64,
                      tie_embeddings=True, rope_theta=1e4)


# Capacity tiers. Training steps differ too — capacity AND compute gaps, like
# the paper's FLAN-t5(800m) vs Llama-2(13b) etc.
TIERS = {
    "tiny": (lm_config("tiny", 1, 32, 2), 150),
    "small": (lm_config("small", 2, 64, 4), 400),
    "medium": (lm_config("medium", 3, 128, 4), 800),
    "large": (lm_config("large", 4, 192, 8), 1500),
}

# paper's three performance-gap regimes
PAIRS = {
    "small_gap": ("medium", "large"),     # Llama-2 7b vs 13b
    "medium_gap": ("small", "large"),     # Llama-2 13b vs GPT-3.5
    "large_gap": ("tiny", "large"),       # FLAN-t5 800m vs Llama-2 13b
}


@dataclasses.dataclass
class TrainedLM:
    tier: str
    cfg: ArchConfig
    bundle: ModelBundle
    params: object        # the trained Decoder module


@dataclasses.dataclass
class PairData:
    """Responses + qualities for one (S, L) pair over one split."""
    q_small: np.ndarray   # (N, n_samples)
    q_large: np.ndarray


@dataclasses.dataclass
class ExperimentData:
    datasets: Dict[str, QueryDataset]          # train/val/test
    lms: Dict[str, TrainedLM]
    qualities: Dict[str, Dict[str, np.ndarray]]  # tier -> split -> (N, S)
    responses: Dict[str, Dict[str, np.ndarray]]
    resp_lengths: Dict[str, Dict[str, np.ndarray]]


def train_tier_lms(tiers=("tiny", "small", "medium", "large"), seed: int = 0,
                   n_train: int = 4000, steps_scale: float = 1.0,
                   batch_size: int = 64, device="cuda"
                   ) -> tuple[Dict[str, TrainedLM], dict]:
    """Train the LM zoo on the synthetic task suite, on ``device``."""
    rng = np.random.default_rng(seed)
    train_ds = generate_dataset(rng, n_train)
    arrays = lm_training_arrays(train_ds)
    lms = {}
    for tier in tiers:
        cfg, steps = TIERS[tier]
        bundle = build_model(cfg)
        params, hist = train_lm(bundle, arrays,
                                TrainConfig(steps=max(20, int(steps * steps_scale)),
                                            batch_size=batch_size,
                                            lr=2e-3, seed=seed),
                                device=device)
        lms[tier] = TrainedLM(tier, cfg, bundle, params)
    return lms, {"train_ds": train_ds}


def response_qualities(lm: TrainedLM, ds: QueryDataset, n_samples: int,
                       max_new_tokens: int = 16, temperature: float = 0.8,
                       seed: int = 0):
    """Sample responses and score them with edit-similarity vs reference."""
    resp, lens = sample_responses(lm.bundle, lm.params, ds.query, n_samples,
                                  max_new_tokens, temperature, seed)
    N, S, T = resp.shape
    q = np.zeros((N, S), np.float32)
    for s in range(S):
        q[:, s] = edit_similarity(resp[:, s], lens[:, s], ds.ref, ds.ref_len)
    return q, resp, lens


def build_experiment(seed: int = 0, n_train_queries: int = 1200,
                     n_test_queries: int = 600, n_samples: int = 10,
                     steps_scale: float = 1.0,
                     tiers=("tiny", "small", "medium", "large"),
                     temperature: float = 0.8, device="cuda"
                     ) -> ExperimentData:
    """Train the tiers' LMs on ``device``, draw the three splits and sample
    ``n_samples`` responses per query from every tier (scored with
    ``edit_similarity``)."""
    lms, _ = train_tier_lms(tiers, seed, steps_scale=steps_scale,
                            device=device)
    rng = np.random.default_rng(seed + 1)
    datasets = {
        "train": generate_dataset(rng, n_train_queries),
        "val": generate_dataset(rng, max(200, n_test_queries // 2)),
        "test": generate_dataset(rng, n_test_queries),
    }
    qualities = {t: {} for t in tiers}
    responses = {t: {} for t in tiers}
    resp_lengths = {t: {} for t in tiers}
    for t in tiers:
        for split, ds in datasets.items():
            # crc32, not hash(): PYTHONHASHSEED randomizes hash() per
            # process, which made sampled qualities (and the tests bounding
            # them) nondeterministic across CI runs
            q, r, l = response_qualities(
                lms[t], ds, n_samples, temperature=temperature,
                seed=seed + zlib.crc32(f"{t}/{split}".encode()) % 1000)
            qualities[t][split] = q
            responses[t][split] = r
            resp_lengths[t][split] = l
    return ExperimentData(datasets, lms, qualities, responses, resp_lengths)


ROUTER_KINDS = ("det", "prob", "trans")

# capacity order of the tier vocabulary, cheapest -> priciest
TIER_ORDER = tuple(TIERS)


def make_labels(kind: str, q_small: np.ndarray, q_large: np.ndarray):
    """Labels per router kind. Returns (labels, t_star_or_0)."""
    if kind == "det":
        return labels_lib.det_labels(q_small, q_large), 0.0
    if kind == "prob":
        return labels_lib.prob_labels(q_small, q_large), 0.0
    if kind == "trans":
        y, t = labels_lib.trans_labels(q_small, q_large)
        return y, t
    raise ValueError(kind)


def train_pair_routers(exp: ExperimentData, small_tier: str, large_tier: str,
                       kinds=ROUTER_KINDS, epochs: int = 5, seed: int = 0,
                       rcfg: RouterConfig | None = None, device="cuda"):
    """Train r_det / r_prob / r_trans for one model pair, on ``device``.

    Returns dict kind -> {params (the RouterEncoder), rcfg, scores:
    split->np.ndarray, t_star, history, label_kind}."""
    rcfg = rcfg or RouterConfig(vocab_size=tok.VOCAB_SIZE, n_layers=2,
                                d_model=64, n_heads=4, d_ff=256)
    tr = exp.datasets["train"]
    va = exp.datasets["val"]
    out = {}
    for kind in kinds:
        y, t_star = make_labels(kind, exp.qualities[small_tier]["train"],
                                exp.qualities[large_tier]["train"])
        yv, _ = make_labels(kind, exp.qualities[small_tier]["val"],
                            exp.qualities[large_tier]["val"])
        params, hist = train_router(
            rcfg, tr.query, tr.query_mask, y,
            RouterTrainConfig(epochs=epochs, seed=seed),
            val=(va.query, va.query_mask, yv), device=device)
        scores = {split: score_dataset(params, rcfg, ds.query, ds.query_mask)
                  for split, ds in exp.datasets.items()}
        out[kind] = {"params": params, "rcfg": rcfg, "scores": scores,
                     "t_star": t_star, "history": hist, "label_kind": kind}
    return out


# ---------------------------------------------------------------- K-tier pool
def _check_tier_order(exp: ExperimentData, tiers):
    if len(tiers) < 2:
        raise ValueError(f"a pool needs at least two tiers, got {tiers}")
    order = [TIER_ORDER.index(t) for t in tiers]
    if order != sorted(order):
        raise ValueError(f"tiers must be cheapest -> priciest "
                         f"(TIER_ORDER {TIER_ORDER}): {tiers}")
    missing = [t for t in tiers if t not in exp.qualities]
    if missing:
        raise ValueError(f"experiment has no qualities for tiers {missing}")


def train_pool_router(exp: ExperimentData, tiers, kind: str = "trans",
                      epochs: int = 5, seed: int = 0,
                      rcfg: RouterConfig | None = None,
                      device="cuda") -> dict:
    """Routers for a K-tier pool over ``tiers`` (cheapest -> priciest in
    the TIERS vocabulary): one BCE head per ADJACENT tier pair — boundary
    b is trained on (tiers[b], tiers[b+1])'s own quality gap, so middle
    tiers are chosen on their own gaps rather than sharing the (cheapest,
    priciest) score. Returns ``{"boundaries": [pair dicts
    cheapest-pair-first], "tiers": ..., "kind": ...}``; feed it to
    ``pool_policy`` for K-1 independently calibrated gates."""
    _check_tier_order(exp, tiers)
    boundaries = [
        train_pair_routers(exp, lo, hi, kinds=(kind,), epochs=epochs,
                           seed=seed + b, rcfg=rcfg, device=device)[kind]
        for b, (lo, hi) in enumerate(zip(tiers, tiers[1:]))]
    return {"boundaries": boundaries, "tiers": tuple(tiers), "kind": kind}


def pool_policy(exp: ExperimentData, router_out: dict, tiers,
                kind: str = "cascade", split: str = "val",
                max_drop_pct: float = 1.0, quality_target: float = 0.0,
                n_bins: int = 8):
    """A ``RoutingPolicy`` over ``tiers`` from one experiment.

    ``router_out`` is what ``train_pool_router`` returned, or one router
    of ``train_pair_routers`` over (tiers[0], tiers[-1]). A per-boundary
    dict (``"boundaries"`` key) with ``kind="cascade"`` calibrates each
    gate from its OWN ``calibration_frontier`` sweep — boundary b's scores
    against (tiers[b], tiers[b+1])'s qualities on ``split`` at
    ``max_drop_pct`` — and builds a per-boundary ``CascadePolicy``. A
    single router gets the shared-score path: K-1 thresholds from one
    sweep of the (cheapest, priciest) qualities.
    ``kind="quality_target"``: per-tier score->quality maps calibrated on
    ``split`` for the runtime quality dial, starting at
    ``quality_target`` (a per-boundary dict contributes its cheapest
    gate's head as the score source)."""
    from .routing import CascadePolicy, HybridRouter, QualityTargetPolicy
    from .thresholds import (best_feasible, calibration_frontier,
                             cascade_thresholds)
    _check_tier_order(exp, tiers)
    if "boundaries" in router_out:
        bs = router_out["boundaries"]
        if len(bs) != len(tiers) - 1:
            raise ValueError(f"{len(tiers)} tiers need {len(tiers) - 1} "
                             f"boundary routers, got {len(bs)}")
        if kind == "cascade":
            gates = []
            for b, out in enumerate(bs):
                frontier = calibration_frontier(
                    out["scores"][split],
                    exp.qualities[tiers[b]][split],
                    exp.qualities[tiers[b + 1]][split])
                cal = best_feasible(frontier, max_drop_pct)
                gates.append(HybridRouter(
                    out["params"], out["rcfg"], cal.threshold,
                    out.get("label_kind", "trans")))
            return CascadePolicy(boundaries=tuple(gates))
        if kind == "quality_target":
            router_out = bs[0]   # cheapest gate's head scores every tier
        else:
            raise ValueError(f"unknown pool policy kind {kind!r}")
    scores = router_out["scores"][split]
    if kind == "cascade":
        frontier = calibration_frontier(scores,
                                        exp.qualities[tiers[0]][split],
                                        exp.qualities[tiers[-1]][split])
        ts = cascade_thresholds(frontier, len(tiers), max_drop_pct)
        router = HybridRouter(router_out["params"], router_out["rcfg"],
                              ts[0], router_out.get("label_kind", "trans"))
        return CascadePolicy(router, tuple(ts))
    if kind == "quality_target":
        router = HybridRouter(router_out["params"], router_out["rcfg"], 0.5,
                              router_out.get("label_kind", "trans"))
        return QualityTargetPolicy.fit(
            router, scores, [exp.qualities[t][split] for t in tiers],
            quality_target, n_bins)
    raise ValueError(f"unknown pool policy kind {kind!r}")

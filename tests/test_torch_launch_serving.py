"""The serving half of the port's serving launcher
(``repro_torch.launch.serve.serve_tiers``) against the JAX launcher's
serving section (``repro/launch/serve.py:273-341``), rebuilt here from the
reference's own components, on reference-initialised tier and router
weights: a 3-tier continuous pool with a prefix tree and speculation, and
the dense two-tier pair. Thresholds sit in gaps of the router's scores at
least 1e-4 wide, so fp differences cannot flip a route; the per-tier
calls, generated tokens, side columns and both cost advantages must be
equal, and the report rows in the reference's form. fp32 at "highest"
matmul precision on both sides; greedy tokens exact."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core.routing import CascadePolicy as JaxCascadePolicy
from repro.core.routing import CostMeter as JaxCostMeter
from repro.core.routing import HybridRouter as JaxRouter
from repro.core.routing import ThresholdPolicy as JaxThresholdPolicy
from repro.core.routing import TierMeter as JaxTierMeter
from repro.data.tasks import generate_dataset
from repro.launch import serve as jax_serve
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.models import router_score as jax_router_score
from repro.serving import ContinuousPoolEngine as JaxPool
from repro.serving import HybridEngine as JaxHybridEngine
from repro.serving.engine import make_engine as jax_make_engine
from repro_torch import bridge
from repro_torch.launch import serve
from repro_torch.models.encoder import RouterConfig
from test_torch_launch import _same
from test_torch_serving import (RefEngines, _np_tree,  # noqa: F401
                                highest_precision)


def _gap_thresholds(scores, fracs, min_gap=1e-4):
    """One threshold a fraction, each in the middle of a gap of the sorted
    scores at least ``min_gap`` wide (the gap nearest that quantile), so
    fp differences between the two routers cannot flip a route; highest
    first."""
    s = np.sort(scores)
    gaps = np.flatnonzero(np.diff(s) >= min_gap)
    assert len(gaps) >= len(fracs), "no room for the thresholds"
    out = []
    for f in fracs:
        i = gaps[np.argmin(np.abs(gaps - f * len(s)))]
        out.append(float((s[i] + s[i + 1]) / 2))
    return sorted(out, reverse=True)


def _ref_row(name, row):
    """A tier's report row as ``repro/launch/serve.py:350-356`` prints
    it."""
    rob = "".join(f"  {row[k]} {k.replace('_', ' ')}"
                  for k in ("preemptions", "sheds", "deadline_misses",
                            "reprefill_tokens", "drafted", "accepted",
                            "rejected", "escalations", "esc_tokens")
                  if row.get(k))
    return (f"  {name:<16} {row['calls']:>5} calls  "
            f"{row['gen_tokens']:>6} tokens{rob}")


CASES = {
    "continuous-3tier": ["--arch", "qwen1.5-32b", "--tiers", "quarter",
                         "half", "full", "--continuous", "--prefix-cache",
                         "8", "--spec-gamma", "2"],
    "dense-pair": ["--arch", "gemma3-4b"],
}
N_REQUESTS = 24


def _ref_serving(cfgs, params, rparams, rcfg, threshold, thresholds, args,
                 rng):
    """``repro.launch.serve.main``'s serving section (`:273-341`), from
    the reference's own components; its continuous engines wait on each
    dispatch (``RefEngines``). Returns its tier meter."""
    layout = "paged" if args.continuous else "dense"
    engines = [jax_make_engine(jax_build_model(dataclasses.replace(
                   cfg, cache_layout=layout)), p, max_new_tokens=12,
                   n_slots=8, max_seq=64, prefill_chunk=args.prefill_chunk,
                   prefill_pack=args.prefill_pack,
                   walk_bound=args.walk_bound, max_pending=args.max_pending,
                   prefix_cache=args.prefix_cache)
               for cfg, p in zip(cfgs, params)]
    router = JaxRouter(rparams, rcfg, threshold)
    if args.continuous:
        policy = JaxThresholdPolicy(router) if len(cfgs) == 2 \
            else JaxCascadePolicy(router, thresholds)
        hy = JaxPool(policy, list(zip((c.name for c in cfgs), engines)),
                     spec_gamma=args.spec_gamma)
        refs = RefEngines()
        for eng in engines:
            refs.adopt(eng)
    else:
        hy = JaxHybridEngine(router, engines[0], engines[1])
        hy.meter = JaxCostMeter(JaxTierMeter((cfgs[0].name, cfgs[1].name)))
    req = generate_dataset(rng, args.requests)
    for i in range(0, args.requests, 64):
        hy.serve(req.query[i:i + 64], req.query_mask[i:i + 64])
    return hy.meter if args.continuous else hy.meter.tiers


@pytest.mark.parametrize("case", CASES)
def test_serving_half_matches_reference(case, capsys):
    """``serve_tiers`` on reference-initialised tier and router weights
    serves the stream as the reference's serving section does: the same
    per-tier calls, generated tokens and side columns, the same cost
    advantages, and report rows in the reference's form."""
    args = serve.parser().parse_args(
        CASES[case] + ["--requests", str(N_REQUESTS), "--device", "cpu"])
    cfgs = serve.check_flags(args)
    ref_cfgs = jax_serve.resolve_tiers(args.arch, args.tiers)
    params, models = [], []
    for seed, (cfg, ref) in enumerate(zip(cfgs, ref_cfgs)):
        _same(cfg, ref)
        p = jax.jit(jax_build_model(ref).init)(jax.random.PRNGKey(seed))
        params.append(p)
        models.append(bridge.params_from_numpy(_np_tree(p), cfg, "cpu"))
    rcfg = JaxRouterConfig(vocab_size=48, n_layers=2, d_model=64, n_heads=4,
                           d_ff=256)
    rparams = jax.jit(jax_init_router, static_argnums=1)(
        jax.random.PRNGKey(9), rcfg)
    pcfg = RouterConfig(**dataclasses.asdict(rcfg))
    router = bridge.params_from_numpy(_np_tree(rparams), pcfg, "cpu")
    stream = generate_dataset(np.random.default_rng(7), N_REQUESTS)
    scores = np.asarray(jax_router_score(rparams, jnp.asarray(stream.query),
                                         jnp.asarray(stream.query_mask),
                                         rcfg))
    if len(cfgs) == 2:
        (threshold,), thresholds = _gap_thresholds(scores, [0.5]), None
    else:
        thresholds = tuple(_gap_thresholds(scores, [0.3, 0.7]))
        threshold = thresholds[0]

    hy = serve.serve_tiers(cfgs, models, router, pcfg, threshold, thresholds,
                           args, np.random.default_rng(7))
    got = hy.meter if args.continuous else hy.meter.tiers
    want = _ref_serving(ref_cfgs, params, rparams, rcfg, threshold,
                        thresholds, args, np.random.default_rng(7))
    assert got.summary() == want.summary()
    assert got.cost_advantage == want.cost_advantage
    assert got.token_cost_advantage == want.token_cost_advantage
    summary = want.summary()
    assert sum(r["calls"] for r in summary.values()) == N_REQUESTS
    assert all(r["calls"] for r in summary.values()), summary
    out = capsys.readouterr().out
    lines = out.splitlines()
    for name, row in summary.items():
        assert _ref_row(name, row) in lines, name
    assert (f"  cost advantage: {want.cost_advantage:.0%} of calls, "
            f"{want.token_cost_advantage:.0%} of generated tokens off "
            f"{cfgs[-1].name}") in out
    if args.continuous:
        assert sum(r["drafted"] for r in summary.values()) > 0
        assert f"{cfgs[0].name}: prefix " in out
        for eng in hy.engines:
            tree = eng.cache.prefix
            resident = tree.resident if tree is not None else 0
            assert eng.cache.free_pages + resident == eng.cache.num_pages - 1

"""The port's fused K-tier decode step (``serving.pool
.build_fused_pool_step``) and its two-tier wrapper (``serving.hybrid
.build_fused_hybrid_step``) against the reference's on bridged weights:
logits within 1e-5, tiers equal; the two ValueErrors of a bad threshold
list; the wrapper selects what the pool step selects. fp32 at "highest"
matmul precision on both sides."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.serving.hybrid import build_fused_hybrid_step as jax_fused_hybrid
from repro.serving.pool import build_fused_pool_step as jax_fused_pool
from repro_torch import bridge
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig, init_router_encoder
from repro_torch.models.model import build_model
from repro_torch.serving.hybrid import build_fused_hybrid_step
from repro_torch.serving.pool import build_fused_pool_step
from conftest import tiny_cfg

TOL = 1e-5
B, S = 6, 8


@pytest.fixture(autouse=True)
def highest_precision():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


def _tiers():
    """Three dense tiers of different widths, vocab paddings and depths."""
    return [tiny_cfg(name="t0", d_model=32, n_layers=1),
            tiny_cfg(name="t1", vocab_pad_multiple=128),
            tiny_cfg(name="t2", d_model=96, n_layers=3, n_heads=6,
                     n_kv_heads=3)]


def _setup(cfgs, seed=0):
    """Port bundles, modules and prefilled caches; the reference's bundles,
    params and caches on the same weights and prompts; the router both
    ways; the router batch."""
    rcfg = RouterConfig(vocab_size=256, n_layers=1, d_model=32, n_heads=4,
                        d_ff=64)
    router = init_router_encoder(rcfg, torch.Generator().manual_seed(seed),
                                 "cpu")
    r_params = jax.tree_util.tree_map(
        jnp.asarray, bridge.numpy_from_params(router, rcfg))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(3, 256, (B, S)).astype(np.int32)
    rtok = rng.integers(3, 256, (B, 12)).astype(np.int32)
    rmask = np.ones((B, 12), np.float32)
    rmask[::2, 7:] = 0
    port, ref = [], []
    for i, cfg in enumerate(cfgs):
        pcfg = ArchConfig(**dataclasses.asdict(cfg))
        bundle = build_model(pcfg)
        m = bundle.init(torch.Generator().manual_seed(seed + 1 + i), "cpu")
        _, cache = bundle.prefill(m, {"tokens": torch.as_tensor(prompts)},
                                  S + 4)
        jb = jax_build_model(cfg)
        jp = jax.tree_util.tree_map(jnp.asarray,
                                    bridge.numpy_from_params(m, pcfg))
        _, jc = jb.prefill(jp, {"tokens": jnp.asarray(prompts)}, S + 4)
        port.append((bundle, m, cache))
        ref.append((jb, jp, jc))
    return (rcfg, router, r_params, rtok, rmask, port, ref)


def _thresholds(router, rcfg, rtok, rmask, k):
    """K-1 gates at score quantiles, so every tier gets rows."""
    from repro_torch.models.encoder import router_score
    with torch.no_grad():
        s = router_score(router, torch.as_tensor(rtok),
                         torch.as_tensor(rmask), rcfg).numpy()
    return sorted(np.quantile(s, np.linspace(0, 1, k + 1)[1:-1]),
                  reverse=True)


def test_fused_pool_step_matches_reference():
    rcfg, router, r_params, rtok, rmask, port, ref = _setup(_tiers())
    th = _thresholds(router, rcfg, rtok, rmask, 3)
    jrcfg = JaxRouterConfig(**dataclasses.asdict(rcfg))
    step = build_fused_pool_step(rcfg, [b for b, _, _ in port], th)
    jstep = jax_fused_pool(jrcfg, [b for b, _, _ in ref], th)
    token = np.full((B, 1), 5, np.int32)
    for t in range(2):
        logits, caches, tier = step(
            router, tuple(m for _, m, _ in port), torch.as_tensor(rtok),
            torch.as_tensor(rmask), tuple(c for _, _, c in port),
            torch.as_tensor(token))
        jl, jcs, jt = jstep(r_params, tuple(p for _, p, _ in ref),
                            jnp.asarray(rtok), jnp.asarray(rmask),
                            tuple(c for _, _, c in ref), jnp.asarray(token))
        np.testing.assert_array_equal(tier.numpy(), np.asarray(jt))
        assert set(tier.tolist()) == {0, 1, 2}
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=TOL, atol=TOL)
        ref = [(b, p, c) for (b, p, _), c in zip(ref, jcs)]
        assert all(c is pc for c, (_, _, pc) in zip(caches, port))
        for c, jc in zip(caches, jcs):
            np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]),
                                       rtol=TOL, atol=TOL)
            assert c["pos"] == int(jc["pos"])
        token = logits.argmax(-1, keepdim=True).int().numpy()


def test_fused_pool_step_rows_take_their_tier():
    """Each row's logits equal its tier's own decode_step logits, bit for
    bit, cut to the smallest padded vocab."""
    rcfg, router, _, rtok, rmask, port, _ = _setup(_tiers(), seed=3)
    th = _thresholds(router, rcfg, rtok, rmask, 3)
    own = [b.decode_step(m, {**c, "k": c["k"].clone(), "v": c["v"].clone()},
                         torch.full((B, 1), 7))[0]
           for b, m, c in port]
    step = build_fused_pool_step(rcfg, [b for b, _, _ in port], th)
    logits, _, tier = step(router, tuple(m for _, m, _ in port),
                           torch.as_tensor(rtok), torch.as_tensor(rmask),
                           tuple(c for _, _, c in port),
                           torch.full((B, 1), 7))
    V = min(o.shape[-1] for o in own)
    assert logits.shape == (B, V)
    for r in range(B):
        assert torch.equal(logits[r], own[int(tier[r])][r, :V])


@pytest.mark.parametrize("th, msg", [((0.5,), "3 tiers need 2"),
                                     ((0.2, 0.6), "non-increasing")])
def test_fused_pool_step_refuses_bad_thresholds(th, msg):
    rcfg = RouterConfig(vocab_size=256, n_layers=1, d_model=32, n_heads=4,
                        d_ff=64)
    bundles = [build_model(ArchConfig(**dataclasses.asdict(c)))
               for c in _tiers()]
    with pytest.raises(ValueError, match=msg):
        build_fused_pool_step(rcfg, bundles, th)
    with pytest.raises(ValueError, match=msg):
        jax_fused_pool(JaxRouterConfig(**dataclasses.asdict(rcfg)),
                       [jax_build_model(c) for c in _tiers()], th)


def test_fused_hybrid_step_is_the_two_tier_pool_step():
    cfgs = _tiers()[:2]
    rcfg, router, r_params, rtok, rmask, port, ref = _setup(cfgs, seed=5)
    th = _thresholds(router, rcfg, rtok, rmask, 2)[0]
    (bs, ms, cs), (bl, ml, cl) = port
    token = torch.full((B, 1), 9)
    hstep = build_fused_hybrid_step(rcfg, bs, bl, th)
    pstep = build_fused_pool_step(rcfg, (bs, bl), (th,))
    clone = lambda c: {**c, "k": c["k"].clone(), "v": c["v"].clone()}
    logits, sc, lc, small = hstep(router, ms, ml, torch.as_tensor(rtok),
                                  torch.as_tensor(rmask), clone(cs),
                                  clone(cl), token)
    pl, _, tier = pstep(router, (ms, ml), torch.as_tensor(rtok),
                        torch.as_tensor(rmask), (clone(cs), clone(cl)),
                        token)
    assert torch.equal(small, tier == 0) and 0 < int(small.sum()) < B
    assert torch.equal(logits, pl)
    jstep = jax_fused_hybrid(JaxRouterConfig(**dataclasses.asdict(rcfg)),
                             ref[0][0], ref[1][0], th)
    jl, _, _, jsmall = jstep(r_params, ref[0][1], ref[1][1],
                             jnp.asarray(rtok), jnp.asarray(rmask),
                             ref[0][2], ref[1][2], jnp.asarray(token.numpy()))
    np.testing.assert_array_equal(small.numpy(), np.asarray(jsmall))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)

"""The port's SSM family (mamba2-style attention-free SSD stacks) on both
serving paths, against the JAX package on bridged weights: the four
decoder entry points (paged chunk and decode step over the recurrent-state
pool, dense prefill and decode step), the recurrent-state pool, the
continuous engine and the dense ``Engine`` (greedy tokens), the two-tier
routed pool, and inside the port continuous == dense, packed == per-slot,
slot reuse and sequential serves. Reference engines wait on each dispatch
(tests/test_torch_serving.py::_synchronous)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.routing import HybridRouter as JaxRouter
from repro.core.routing import ThresholdPolicy as JaxThresholdPolicy
from repro.data.tasks import generate_dataset
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import decoder as jax_decoder
from repro.models import init_router_encoder as jax_init_router
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro.serving import Engine as JaxDenseEngine
from repro.serving import RecurrentStatePool as JaxStatePool
from repro_torch import bridge
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
from repro_torch.core.routing import HybridRouter, ThresholdPolicy
from repro_torch.models import decoder
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import build_model
from repro_torch.serving.cache import RecurrentStatePool
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg
from test_torch_serving import _synchronous

ATOL = 1e-4    # logits / state slabs: fp32, another summation order


@pytest.fixture(autouse=True)
def highest_precision():
    """fp32 matmuls at full precision on both sides (PyTorch's default),
    and one PyTorch thread: these shapes are tiny, and the test workers
    share the machine's cores."""
    assert torch.get_float32_matmul_precision() == "highest"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tier(cfg, seed):
    """(reference bundle, reference params, port bundle, port model)."""
    m = jax_build_model(cfg)
    p = jax.jit(m.init)(jax.random.PRNGKey(seed))
    pcfg = ArchConfig(**dataclasses.asdict(cfg))
    return m, p, build_model(pcfg), bridge.params_from_numpy(_np_tree(p),
                                                             pcfg, "cpu")


@pytest.fixture(scope="module")
def ssm():
    return _tier(tiny_cfg("ssm", cache_layout="paged", prefill_chunk=4), 0)


def _queries(vocab, n, L, seed):
    return np.random.default_rng(seed).integers(4, vocab, (n, L)) \
        .astype(np.int32)


# ---------------------------------------------------------------- config
def test_mamba2_config_and_init_follow_reference():
    """The copied config equals the reference's field for field, and
    ``init_params_`` fills the SSM leaves from the reference's formulas."""
    from repro.configs.mamba2_130m import CONFIG as JAX_MAMBA
    assert dataclasses.asdict(MAMBA) == dataclasses.asdict(JAX_MAMBA)
    assert (MAMBA.d_inner, MAMBA.ssm_nheads) == (1536, 24)
    cfg = tiny_cfg("ssm")
    p = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))
    port = decoder.init_decoder(ArchConfig(**dataclasses.asdict(cfg)),
                                torch.Generator().manual_seed(0), "cpu")
    mixer = port.layers[1].ssm
    for leaf in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(getattr(mixer, leaf).numpy(), np.asarray(
            p["layers"]["ssm"][leaf][1]), rtol=1e-6, err_msg=leaf)
    assert (mixer.norm.scale == 1).all() and (port.layers[0].ln.scale
                                              == 1).all()
    assert mixer.conv_w.abs().max() <= 0.4 + 1e-7   # 0.2 std, cut at 2 std
    assert mixer.w_in.abs().max() <= 2 * cfg.d_model ** -0.5 + 1e-7


# --------------------------------------------------------------- decoder
def test_paged_decoder_matches_reference(ssm):
    """Three prefill chunks over the recurrent-state pool (ragged rows, an
    n_new = 0 padding row on the scratch row, a chunk mid-prompt, and a
    row whose slot is reused from position 0 over stale state), then two
    decode steps (the second with idle slots): logits and every state row
    but the scratch row, after every call."""
    m, p, bundle, port = ssm
    cfg, pcfg = m.cfg, bundle.cfg
    ps, n_slots, C = 4, 3, 8
    pt = np.zeros((n_slots, 8), np.int32)          # no attention layers
    rng = np.random.default_rng(1)
    jcache = {**jax_decoder.init_paged_decode_cache(cfg, 4, ps),
              "rec": jax_decoder.init_decoder_recurrent_state(cfg,
                                                              n_slots + 1)}
    tcache = {**decoder.init_paged_decode_cache(pcfg, 4, ps, "cpu"),
              "rec": bundle.init_recurrent_state(n_slots + 1, device="cpu")}
    prefill = jax.jit(lambda c, t, s, n, r: jax_decoder.
                      decoder_prefill_paged_chunk(p, c, t, jnp.asarray(pt),
                                                  s, n, cfg, state_rows=r))
    decode = jax.jit(lambda c, t, sl, a: jax_decoder.
                     decoder_decode_step_paged(p, c, t, jnp.asarray(pt), sl,
                                               a, cfg))
    T = torch.tensor

    def check(jl, tl, what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=what)
        # every row but the scratch row 0, where padding rows write
        # duplicates in an order neither framework fixes
        for k in ("h", "conv"):
            np.testing.assert_allclose(
                tcache["rec"][k][1:].numpy(),
                np.asarray(jcache["rec"][k])[1:], atol=ATOL,
                err_msg=f"{what}: {k}")

    # (state rows, start, n_new): slot 0 and slot 1 stream their prompts,
    # then slot 0 is reused for a fresh prompt at position 0
    for rows, start, n_new in (([1, 2, 0], [0, 0, 0], [8, 5, 0]),
                               ([1, 2, 0], [8, 5, 0], [4, 7, 0]),
                               ([2, 1, 0], [12, 0, 0], [3, 6, 0])):
        args = [np.asarray(a, np.int32) for a in (start, n_new, rows)]
        toks = rng.integers(4, cfg.vocab_size, (3, C)).astype(np.int32)
        x, jcache = prefill(jcache, jnp.asarray(toks), *map(jnp.asarray,
                                                            args))
        tx = decoder.decoder_prefill_paged_chunk(
            port, tcache, T(toks), T(pt), *map(T, args[:2]), pcfg,
            state_rows=T(args[2]))
        check(m.lm_head(p, x), decoder._unembed(port, tx, pcfg),
              f"prefill chunk rows {rows} at {start}")
    lens = np.array([15, 6, 0], np.int32)
    for active in (np.array([True, True, False]),
                   np.array([True, False, False])):
        toks = rng.integers(4, cfg.vocab_size, (n_slots, 1)).astype(np.int32)
        jl, jcache = decode(jcache, jnp.asarray(toks), jnp.asarray(lens),
                            jnp.asarray(active))
        tl = decoder.decoder_decode_step_paged(
            port, tcache, T(toks), T(pt), T(lens), T(active), pcfg)
        check(jl, tl, f"decode, active {active}")
        lens = lens + active


@pytest.mark.parametrize("S", [13, 2], ids=["padded_chunk", "short_tail"])
def test_dense_decoder_matches_reference(ssm, S):
    """Prefill (S padded to the SSD chunk; S below the conv width's tail)
    then two decode steps: logits and both state slabs after each call."""
    m, p, bundle, port = ssm
    cfg, pcfg = m.cfg, bundle.cfg
    rng = np.random.default_rng(S)
    toks = rng.integers(4, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jax.jit(lambda t: m.prefill(p, {"tokens": t}))(jnp.asarray(toks))
    tl, tc = bundle.prefill(port, {"tokens": torch.tensor(toks)})
    step = jax.jit(lambda c, t: m.decode_step(p, c, t))

    def check(what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=what)
        for k in ("ssm_h", "ssm_conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL, err_msg=f"{what}: {k}")
        assert tc["pos"] == int(jc["pos"])

    check("prefill")
    for i in range(2):
        tok = rng.integers(4, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = step(jc, jnp.asarray(tok))
        tl, tc = bundle.decode_step(port, tc, torch.tensor(tok))
        check(f"decode {i}")


def test_recurrent_state_pool_matches_reference(ssm):
    m, _, bundle, _ = ssm
    ref = JaxStatePool(m, 3)
    port = RecurrentStatePool(bundle, 3, device="cpu")
    assert port.state_bytes == ref.state_bytes
    for k in ("h", "conv"):
        assert tuple(port.state[k].shape) == ref.state[k].shape
    np.testing.assert_array_equal(port.rows([0, 2]), ref.rows([0, 2]))
    dense = build_model(ArchConfig(**dataclasses.asdict(tiny_cfg("dense"))))
    assert dense.init_recurrent_state is None
    with pytest.raises(ValueError):
        RecurrentStatePool(dense, 3, device="cpu")


# ---------------------------------------------------------------- engines
LENS = (3, 17, 1, 9, 12, 6)
CAPS = (4, 8, 6, 2, 8, 5)
# pages of 16 tokens keep the reference's decode walks (and so its jit
# compiles) few: an SSM stack reads no page
ENGINE_KW = dict(max_new_tokens=8, n_slots=2, page_size=16, max_seq=32,
                 prefill_chunk=4)


def _serve(engine_cls, bundle, params, **kw):
    rng = np.random.default_rng(8)
    prompts = [rng.integers(4, bundle.cfg.vocab_size, (n,)).astype(np.int32)
               for n in LENS]
    eng = engine_cls(bundle, params, **ENGINE_KW, **kw)
    if engine_cls is JaxEngine:
        _synchronous(eng)
    reqs = [eng.submit(t, max_new_tokens=c) for t, c in zip(prompts, CAPS)]
    eng.run()
    return [r.out for r in reqs], eng


def test_continuous_engine_matches_reference(ssm):
    """Ragged prompts through fewer slots than requests (chunked prefill
    over several steps, packed rows with padding, mid-stream retirement,
    slot reuse): the reference's greedy tokens request for request, the
    same step and dispatch counts, no page leaked."""
    m, p, bundle, model = ssm
    want, ref = _serve(JaxEngine, m, p)
    got, eng = _serve(ContinuousEngine, bundle, model)
    assert got == want
    for f in ("admitted", "retired", "prefill_tokens", "decode_tokens",
              "prefill_chunks", "prefill_dispatches", "prefill_compiles",
              "decode_steps", "steps"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert eng.rstate.state_bytes == ref.rstate.state_bytes
    assert eng.cache.free_pages == eng.cache.num_pages - 1


def test_engine_dispatch_variants_agree_within_the_port(ssm):
    """Packed == per-slot and live == static inside the port."""
    _, _, bundle, model = ssm
    base, _ = _serve(ContinuousEngine, bundle, model, walk_bound="static",
                     prefill_pack=0)
    out, eng = _serve(ContinuousEngine, bundle, model)
    assert out == base
    assert eng.stats.prefill_dispatches < eng.stats.prefill_chunks


def test_dense_engine_matches_reference(ssm):
    m, p, bundle, model = ssm
    q = _queries(m.cfg.vocab_size, 5, 11, 2)
    want = JaxDenseEngine(m, p, max_new_tokens=6).serve(q)
    got = Engine(bundle, model, max_new_tokens=6).serve(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_continuous_matches_dense_and_reuses_slots(ssm):
    """Inside the port: 6 uniform-length requests through 2 slots (every
    slot reused after retirement, its state row re-entered from zero) emit
    the dense engine's greedy tokens (tests/test_window_ssm_serving.py's
    contract)."""
    _, _, bundle, model = ssm
    q = _queries(bundle.cfg.vocab_size, 6, 21, 1)
    rd, ld = Engine(bundle, model, max_new_tokens=8).serve(q)
    ce = ContinuousEngine(bundle, model, max_new_tokens=8, n_slots=2,
                          max_seq=64, page_size=4)
    rc, lc = ce.serve(q)
    np.testing.assert_array_equal(rc, rd)
    np.testing.assert_array_equal(lc, ld)
    assert ce.rstate is not None
    assert ce.stats.retired == 6 and ce.cache.stats.allocs >= 6


def test_sequential_serves_match_fresh_engines(ssm):
    """Two serve() calls through one engine == two fresh engines: stale
    state from the first stream never leaks into the second."""
    _, _, bundle, model = ssm
    q1 = _queries(bundle.cfg.vocab_size, 3, 9, 3)
    q2 = _queries(bundle.cfg.vocab_size, 3, 13, 4)
    kw = dict(max_new_tokens=6, n_slots=2, max_seq=32, page_size=4)
    eng = ContinuousEngine(bundle, model, **kw)
    first, second = eng.serve(q1), eng.serve(q2)
    for got, q in ((first, q1), (second, q2)):
        want = ContinuousEngine(bundle, model, **kw).serve(q)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_rejects_one_shot_prefill(ssm):
    _, _, bundle, model = ssm
    with pytest.raises(ValueError, match="chunked prefill"):
        ContinuousEngine(bundle, model, prefill_chunk=0)


# ------------------------------------------------------------------ pool
def test_two_tier_ssm_pool_matches_reference(ssm):
    """A router splits the queries between a small and a large SSM tier,
    both engines step independently: identical tier dispatch, greedy
    tokens and TierMeter summary."""
    small = _tier(tiny_cfg("ssm", name="ssm-small", n_layers=1, d_model=32,
                           cache_layout="paged"), 1)
    large = ssm
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(5),
                                                    rcfg)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    port_router = bridge.params_from_numpy(_np_tree(rp), prcfg, "cpu")
    ds = generate_dataset(np.random.default_rng(3), 8, q_len=12)
    scores = np.sort(np.asarray(JaxRouter(rp, rcfg, 0.0).scores(
        ds.query, ds.query_mask)))
    threshold = float(scores[3] + scores[4]) / 2   # 4 queries each side
    kw = dict(max_new_tokens=5, n_slots=2, max_seq=32, prefill_chunk=16)
    ref = JaxPool(JaxThresholdPolicy(JaxRouter(rp, rcfg, threshold)),
                  [("small", _synchronous(JaxEngine(small[0], small[1], **kw))),
                   ("large", _synchronous(JaxEngine(large[0], large[1], **kw)))])
    want = ref.serve(ds.query, ds.query_mask)
    pool = ContinuousPoolEngine(
        ThresholdPolicy(HybridRouter(port_router, prcfg, threshold)),
        [("small", ContinuousEngine(small[2], small[3], **kw)),
         ("large", ContinuousEngine(large[2], large[3], **kw))])
    got = pool.serve(ds.query, ds.query_mask)
    np.testing.assert_array_equal(got.tier_idx, want.tier_idx)
    assert 0 < got.tier_idx.sum() < len(got.tier_idx)
    np.testing.assert_array_equal(got.responses, want.responses)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert pool.meter.summary() == ref.meter.summary()
    for e in pool.engines:
        assert e.cache.free_pages == e.cache.num_pages - 1

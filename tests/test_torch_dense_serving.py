"""The port's dense-batch serving path against the JAX package on bridged
weights: the dense decoder (prefill + decode steps, plain and windowed),
generation (EOS masking, lengths, sampling), the dense ``Engine``, the
two-tier ``HybridEngine`` and ``ContinuousHybridEngine``, and the
continuous == dense contract inside the port."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.experiment import TIERS
from repro.core.routing import HybridRouter as JaxRouter
from repro.data import tokenizer as jax_tok
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.serving import Engine as JaxEngine
from repro.serving import HybridEngine as JaxHybridEngine
from repro.training.checkpoint import save_checkpoint
from repro_torch import bridge
from repro_torch.core.routing import HybridRouter, ThresholdPolicy
from repro_torch.data import tokenizer as tok
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import ModelBundle, build_model
from repro_torch.serving.engine import (ContinuousEngine, Engine, ServeStats,
                                        make_engine)
from repro_torch.serving.generate import (_sample, build_generate_fn,
                                          sample_responses)
from repro_torch.serving.hybrid import ContinuousHybridEngine, HybridEngine
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg

ATOL = 1e-4    # logits / K-V slabs: fp32, another summation order


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
def dense():
    return _tier(tiny_cfg("dense"), 0)


def _queries(vocab, n, L, seed):
    return np.random.default_rng(seed).integers(4, vocab, (n, L)) \
        .astype(np.int32)


# --------------------------------------------------------------- decoder
@pytest.mark.parametrize("cfg,windowed", [
    (tiny_cfg("dense"), False),                              # GQA, G = 2
    (tiny_cfg("dense", qkv_bias=True, n_kv_heads=4), False),  # MHA + bias
    (TIERS["large"][0], False),                              # head_dim 24
    (tiny_cfg("dense", use_pallas=True), False),   # reference through K5
    (tiny_cfg("dense", long_context_window=4, attention_sink=2), True),
], ids=["gqa", "qkv_bias", "tiers_large", "ref_pallas", "windowed"])
def test_dense_decoder_matches_reference(cfg, windowed):
    """decoder_prefill and three decoder_decode_step calls (greedy tokens
    fed back): logits and both K/V slabs element by element after every
    call. ``use_pallas=True`` runs the reference's decode through its
    Pallas kernel in interpret mode; ``windowed`` attends to a 2-key sink
    plus the last 4 positions, so from the first step on some sink keys
    are masked."""
    m, p, bundle, port = _tier(cfg, 0)
    toks = _queries(cfg.vocab_size, 2, 7, 1)
    jl, jc = jax.jit(m.prefill, static_argnums=2)(
        p, {"tokens": jnp.asarray(toks)}, 10)
    tl, tc = bundle.prefill(port, {"tokens": torch.tensor(toks)}, 10)
    step = jax.jit(lambda c, t: m.decode_step(p, c, t, windowed=windowed))

    def check(what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=what)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL, err_msg=f"{what}: {k}")
        assert tc["pos"] == int(jc["pos"])

    with torch.no_grad():
        check("prefill")
        for i in range(3):
            t = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
            jl, jc = step(jc, jnp.asarray(t))
            tl, tc = bundle.decode_step(port, tc, torch.tensor(t),
                                        windowed=windowed)
            check(f"decode step {i}")


def test_dense_attention_refuses_the_encoder_decoder_paths(dense):
    """The encoder-decoder paths of the dense attention no longer raise
    (they landed with the encoder-decoder family): cross-attention over 9
    keys, ``use_rope=False`` and ``causal=False`` each give the
    reference's ``attention_forward`` on the same layer."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention
    _, p, bundle, port = dense
    cfg = bundle.cfg
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    kv = tuple(rng.standard_normal((2, 9, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)).astype(np.float32)
               for _ in range(2))
    lp = jax.tree_util.tree_map(lambda a: a[0], p["layers"]["attn"])
    layer = port.layers[0].attn
    for kw in (dict(kv_override=kv), dict(use_rope=False),
               dict(causal=False)):
        jkw = {k: tuple(map(jnp.asarray, v)) if k == "kv_override" else v
               for k, v in kw.items()}
        tkw = {k: tuple(map(torch.tensor, v)) if k == "kv_override" else v
               for k, v in kw.items()}
        want = jax_attn.attention_forward(lp, jnp.asarray(x), cfg, **jkw)
        with torch.no_grad():
            got = attention.attention_forward(layer, torch.tensor(x), cfg,
                                              **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=str(list(kw)))


# ------------------------------------------------------------- generate
def _scripted_bundle(cfg, fav_id, eos_at=None):
    """A port ModelBundle (over ``cfg`` converted to the port's
    ``ArchConfig``) whose logits always favour ``fav_id`` until token index
    ``eos_at``, then EOS: an oracle for the length accounting
    (tests/test_serving.py::_scripted_bundle)."""
    cfg = ArchConfig(**dataclasses.asdict(cfg))
    V = cfg.vocab_size

    def logits_at(i, B):
        tid = fav_id if eos_at is None or i < eos_at else tok.EOS
        out = torch.zeros((B, V))
        out[:, tid] = 10.0
        return out

    def prefill(params, inputs, max_seq=None):
        return logits_at(0, inputs["tokens"].shape[0]), {"i": 1}

    def decode_step(params, cache, token, windowed=False):
        return logits_at(cache["i"], token.shape[0]), {"i": cache["i"] + 1}

    return ModelBundle(cfg=cfg, init=None, prefill=prefill,
                       decode_step=decode_step, init_cache=None,
                       init_paged_cache=None, prefill_paged_chunk=None,
                       decode_step_paged=None, lm_head=None)


@pytest.mark.parametrize("eos_at,want_len,want_row", [
    (0, 1, [tok.EOS] + [tok.PAD] * 7),          # EOS on the first token
    (None, 8, [10] * 8),                        # no EOS: full budget
    (7, 8, [10] * 7 + [tok.EOS]),               # EOS on the last token
    (3, 4, [10, 10, 10, tok.EOS] + [tok.PAD] * 4),   # mid-stream EOS
], ids=["first", "none", "last", "mid"])
def test_generate_lengths_and_eos_masking(eos_at, want_len, want_row):
    """tests/test_serving.py's EOS and length cases through the port."""
    gen = build_generate_fn(_scripted_bundle(tiny_cfg("dense"), 10, eos_at),
                            8, 0.0)
    toks, lens = gen(None, {"tokens": torch.zeros((3, 5), dtype=torch.int32)},
                     torch.Generator())
    assert lens.tolist() == [want_len] * 3
    assert toks.tolist() == [want_row] * 3


def test_sample_matches_softmax_distribution():
    """Greedy takes the first maximal index; at temperature 0.7 the draws
    follow softmax(logits / 0.7): every frequency within 0.01 of its
    probability over 40000 rows (5 standard deviations at p = 0.5)."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [0.0, 1.0, 2.0, 0.5]],
                      np.float32)
    g = torch.Generator().manual_seed(0)
    assert _sample(g, torch.tensor(logits), 0.0).tolist() == \
        np.asarray(jnp.argmax(logits, -1)).tolist()
    n, t = 40000, 0.7
    draws = _sample(g, torch.tensor(logits[1:]).repeat(n, 1), t).numpy()
    want = np.exp(logits[1] / t) / np.exp(logits[1] / t).sum()
    np.testing.assert_allclose(np.bincount(draws, minlength=4) / n, want,
                               atol=0.01)


def test_sample_responses_shapes_seeds_and_eos_masking(dense):
    _, _, bundle, model = dense
    q = _queries(bundle.cfg.vocab_size, 5, 6, 2)
    kw = dict(n_samples=3, max_new_tokens=6, temperature=1.5, batch_size=4)
    r1, l1 = sample_responses(bundle, model, q, seed=0, **kw)
    r2, l2 = sample_responses(bundle, model, q, seed=0, **kw)
    r3, _ = sample_responses(bundle, model, q, seed=1, **kw)
    assert r1.shape == (5, 3, 6) and l1.shape == (5, 3)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(l1, l2)
    assert (r1 != r3).any()
    assert (r1[:, 0] != r1[:, 1]).any(), "samples of one query must differ"
    assert ((l1 >= 1) & (l1 <= 6)).all()
    for row, n in zip(r1.reshape(-1, 6), l1.reshape(-1)):
        eos = np.flatnonzero(row == tok.EOS)
        if len(eos):
            assert n == eos[0] + 1 and (row[eos[0] + 1:] == tok.PAD).all()


# ---------------------------------------------------------------- engine
def test_engine_greedy_serve_and_stats_match_reference(dense):
    """Greedy serve on the same weights: tokens, lengths and every
    ServeStats counter equal the reference Engine's, over a warm-up and
    two serves of different buckets."""
    m, p, bundle, model = dense
    ref = JaxEngine(m, p, max_new_tokens=8)
    eng = Engine(bundle, model, max_new_tokens=8)
    for e in (ref, eng):
        e.warmup(12, 2)
    q = _queries(bundle.cfg.vocab_size, 5, 12, 0)
    for batch in (q[:3], q):
        want = ref.serve(batch)
        got = eng.serve(batch)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(eng.serve(q)[0], want[0])   # determinism
    ref.serve(q)
    for f in dataclasses.fields(ServeStats):
        if f.name != "wall_s":
            assert getattr(eng.stats, f.name) == getattr(ref.stats, f.name), \
                f.name
    assert eng.stats.compiles == 4 and eng.stats.pad_slots == 1 + 3 + 3
    assert eng.stats.padding_waste == ref.stats.padding_waste


def test_make_engine_follows_the_cache_layout(dense):
    _, _, bundle, model = dense
    assert type(make_engine(bundle, model, max_new_tokens=4,
                            n_slots=2)) is Engine
    paged = dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, cache_layout="paged"))
    assert type(make_engine(paged, model, max_new_tokens=4, n_slots=2,
                            max_seq=32)) is ContinuousEngine


def test_continuous_matches_dense_greedy(dense):
    """Inside the port (tests/test_continuous_serving.py:76): the paged
    continuous engine, queueing through fewer slots than requests, emits
    the dense engine's greedy tokens and lengths."""
    _, _, bundle, model = dense
    q = _queries(bundle.cfg.vocab_size, 5, 12, 0)
    r1, l1 = Engine(bundle, model, max_new_tokens=8).serve(q)
    ce = ContinuousEngine(bundle, model, max_new_tokens=8, n_slots=2,
                          page_size=8, max_seq=32)
    r2, l2 = ce.serve(q)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(l1, l2)
    assert ce.stats.admitted == 5 and ce.stats.retired == 5
    assert ce.cache.stats.pages_in_use == 0


# ---------------------------------------------------------------- hybrid
@pytest.fixture(scope="module")
def routed(dense):
    """A small and a large tier, a router on bridged weights and a
    threshold splitting 10 queries 5/5."""
    small = _tier(tiny_cfg("dense", name="small", n_layers=1, d_model=32,
                           n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64), 1)
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(5),
                                                    rcfg)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    port_router = bridge.params_from_numpy(_np_tree(rp), prcfg, "cpu")
    q = _queries(256, 10, 12, 3)
    mask = (np.arange(12)[None] < np.array([[12, 5, 9, 12, 3, 12, 7, 12, 11,
                                             2]]).T).astype(np.float32)
    q[mask == 0] = tok.PAD
    scores = np.sort(np.asarray(JaxRouter(rp, rcfg, 0.0).scores(q, mask)))
    threshold = float(scores[4] + scores[5]) / 2
    return dict(small=small, large=dense, rp=rp, rcfg=rcfg,
                router=HybridRouter(port_router, prcfg, threshold),
                threshold=threshold, q=q, mask=mask)


def test_hybrid_engine_matches_reference(routed):
    """Same router weights and threshold as the reference HybridEngine:
    the same routing, scores, greedy responses and lengths (the larger
    budget's PAD tail included) and CostMeter counters, over two calls."""
    s, l = routed["small"], routed["large"]
    ref = JaxHybridEngine(JaxRouter(routed["rp"], routed["rcfg"],
                                    routed["threshold"]),
                          JaxEngine(s[0], s[1], max_new_tokens=4),
                          JaxEngine(l[0], l[1], max_new_tokens=6))
    hy = HybridEngine(routed["router"], Engine(s[2], s[3], max_new_tokens=4),
                      Engine(l[2], l[3], max_new_tokens=6))
    for seed in (0, 7):
        want = ref.serve(routed["q"], routed["mask"], seed=seed)
        got = hy.serve(routed["q"], routed["mask"], seed=seed)
        np.testing.assert_array_equal(got.routed_small, want.routed_small)
        assert 0 < got.routed_small.sum() < len(got.routed_small)
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-6)
        np.testing.assert_array_equal(got.responses, want.responses)
        np.testing.assert_array_equal(got.lengths, want.lengths)
    assert (got.responses[got.routed_small, 4:] == jax_tok.PAD).all()
    for f in ("to_small", "to_large", "small_tokens", "large_tokens",
              "cost_advantage", "token_cost_advantage"):
        assert getattr(hy.meter, f) == getattr(ref.meter, f), f
    assert hy.meter.tiers.summary() == ref.meter.tiers.summary()


def test_continuous_hybrid_engine_is_the_two_tier_pool(routed):
    """The facade's serve, submit/run and meter equal a two-tier
    ContinuousPoolEngine under the same ThresholdPolicy; its greedy
    responses equal the dense HybridEngine's on the same tiers."""
    s, l = routed["small"], routed["large"]
    kw = dict(max_new_tokens=6, n_slots=4, max_seq=32, prefill_chunk=16)
    make = lambda: (ContinuousEngine(s[2], s[3], **kw),
                    ContinuousEngine(l[2], l[3], **kw))
    hy = ContinuousHybridEngine(routed["router"], *make())
    pool = ContinuousPoolEngine(ThresholdPolicy(routed["router"]),
                                list(zip(("small", "large"), make())))
    got = hy.serve(routed["q"], routed["mask"])
    want = pool.serve(routed["q"], routed["mask"])
    np.testing.assert_array_equal(got.routed_small, want.tier_idx == 0)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.responses, want.responses)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert hy.meter.tiers.summary() == pool.meter.summary()
    assert hy.meter.to_small == int(got.routed_small.sum())

    reqs, small, _ = hy.submit(routed["q"][:3], routed["mask"][:3])
    hy.run()
    assert all(r.done for r in reqs) and len(small) == 3
    assert hy.meter.tiers.total_calls == 13

    dense = HybridEngine(routed["router"],
                         Engine(s[2], s[3], max_new_tokens=6),
                         Engine(l[2], l[3], max_new_tokens=6))
    res = dense.serve(routed["q"], routed["mask"])
    np.testing.assert_array_equal(res.routed_small, got.routed_small)
    np.testing.assert_array_equal(res.lengths, got.lengths)
    # the dense engines attend to each prompt's PAD tail, the continuous
    # ones drop it, so only the full-width prompts must agree token for
    # token
    full = routed["mask"].all(axis=1)
    np.testing.assert_array_equal(res.responses[full], got.responses[full])


# ---------------------------------------------------------------- bridge
def test_bridged_checkpoint_drives_the_paged_and_dense_paths(dense,
                                                             tmp_path):
    """A reference checkpoint, loaded through the bridge (which raises on
    any missing, unexpected or mis-shaped key), drives both serving paths
    to the reference Engine's greedy tokens."""
    m, p, bundle, _ = dense
    path = str(tmp_path / "lm.npz")
    save_checkpoint(path, p)
    model = bridge.params_from_numpy(bridge.load_checkpoint(path),
                                     bundle.cfg, "cpu")
    assert {n for n, _ in model.named_parameters()} == \
        set(bridge._state_from_tree(bridge.load_checkpoint(path),
                                    bundle.cfg.n_layers))
    q = _queries(bundle.cfg.vocab_size, 4, 9, 4)
    want = JaxEngine(m, p, max_new_tokens=5).serve(q)
    for eng in (Engine(bundle, model, max_new_tokens=5),
                ContinuousEngine(bundle, model, max_new_tokens=5, n_slots=4,
                                 max_seq=32)):
        got = eng.serve(q)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

"""The port's MoE family (models/moe.py and the decoder's MoE layers)
against the JAX package on bridged weights: ``capacity_of``, the routed
FFN's experts, drop mask, output and Switch aux loss (PAD tails, drops),
every decoder entry point of a MoE stack (dense prefill and decode, paged
chunk, paged decode, verify chunk, the teacher-forced forward with its
aux and gradients), a window + MoE stack, the continuous and dense
engines greedy-exact, and a ``train_lm`` run. fp32 at "highest" matmul
precision on both sides; reference continuous engines wait on each
dispatch (tests/test_torch_serving.py::_synchronous)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.grok_1_314b import CONFIG as JAX_GROK
from repro.configs.jamba_v01_52b import CONFIG as JAX_JAMBA
from repro.configs.phi35_moe_42b import CONFIG as JAX_PHI
from repro.data.tasks import generate_dataset, lm_training_arrays
from repro.models import decoder as jax_decoder
from repro.models import moe as jax_moe
from repro.models.common import softmax_xent as jax_softmax_xent
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Engine as JaxDense
from repro.training.optim import AdamWConfig as JaxAdamWConfig
from repro.training.optim import init_opt_state as jax_init_opt_state
from repro.training.trainer import make_lm_train_step as jax_train_step
from repro_torch import bridge
from repro_torch.models import decoder, moe
from repro_torch.models.common import init_params_, softmax_xent
from repro_torch.models.config import ArchConfig
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.training.optim import AdamWConfig, init_opt_state
from repro_torch.training.trainer import (TrainConfig, make_lm_train_step,
                                          train_lm, trainable)
from conftest import tiny_cfg
from test_torch_serving import (_np_tree, _synchronous, _tier,  # noqa: F401
                                highest_precision)

ATOL = 1e-4       # logits, hidden states, K/V: fp32, another summation order
GRAD_ATOL = 1e-4  # loss gradients: the same, through the backward pass
AUX_RTOL = 1e-5   # the aux loss: a sum of E products of means
LOSS_RTOL = 1e-4  # losses after steps: gradients differ in the last bits

MOE = tiny_cfg("moe", cache_layout="paged", prefill_chunk=4)


@pytest.fixture(scope="module")
def moe_tier():
    return _tier(MOE, 0)


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


# ------------------------------------------------------------ the layer
def test_capacity_of_matches_reference():
    for cfg in (tiny_cfg("moe"), tiny_cfg("moe", capacity_factor=0.1),
                JAX_PHI, JAX_JAMBA, JAX_GROK):
        for tokens in (1, 2, 7, 16, 100, 128, 512, 1000, 4096, 65536):
            assert moe.capacity_of(tokens, _port_cfg(cfg)) == \
                jax_moe.capacity_of(tokens, cfg), (cfg.name, tokens)


def test_moe_init_follows_reference_distributions():
    """``init_params_`` draws an MoE layer's weights as ``init_moe`` does,
    in a bare ``MoE`` and in a decoder layer alike: the gate over fan-in
    D, the experts' (E, fan-in, fan-out) weights over their second axis,
    each a normal truncated at 2 standard deviations."""
    cfg = _port_cfg(tiny_cfg("moe", d_model=128, d_ff=256))
    bare = init_params_(moe.MoE(cfg, "cpu"), torch.Generator().manual_seed(0))
    layer = decoder.init_decoder(cfg, torch.Generator().manual_seed(1),
                                 "cpu").layers[1].moe
    for m in (bare, layer):
        for w, fan_in in ((m.w_gate_logits, 128), (m.w_in, 128),
                          (m.w_glu, 128), (m.w_out, 256)):
            std = fan_in ** -0.5
            assert w.abs().max() <= 2 * std + 1e-7
            # N(0, 1) truncated to +-2 has standard deviation 0.8796
            assert abs(w.std().item() / (0.8796 * std) - 1) < 0.05


def _ref_route(p, x, cfg):
    """The reference's chosen experts (B, S, k) and, from its
    ``_dispatch_group``, its keep mask in assignment order (B, S·k)."""
    probs = jax.nn.softmax((x @ p["w_gate_logits"]).astype(jnp.float32), -1)
    top_w, top_i = jax.lax.top_k(probs, cfg.top_k)
    C = jax_moe.capacity_of(x.shape[1], cfg)
    keeps = []
    for b in range(x.shape[0]):
        _, (_, order, keep) = jax_moe._dispatch_group(
            x[b], top_i[b], top_w[b], cfg.n_experts, cfg.top_k, C)
        mask = np.zeros(keep.shape, bool)
        mask[np.asarray(order)] = np.asarray(keep)
        keeps.append(mask)
    return np.asarray(top_i), np.stack(keeps)


@pytest.mark.parametrize("capacity_factor,S,pad_lens,drops", [
    (1.25, 24, (0, 10, 20), False),
    # a PAD tail of 150 routes 150 assignments to each of its two experts,
    # past the (rounded-up) capacity of 128
    (0.1, 160, (150, 40, 0), True),
], ids=["pad_tails", "drops"])
def test_moe_forward_matches_reference(capacity_factor, S, pad_lens, drops):
    """Rows whose tails repeat one PAD vector (identical gate scores, so
    stable sorting decides the ranks): the chosen experts and the drop
    mask exactly equal, then the output within ATOL and the aux loss
    within AUX_RTOL, on the same weights."""
    cfg = tiny_cfg("moe", capacity_factor=capacity_factor)
    layer = init_params_(moe.MoE(_port_cfg(cfg), "cpu"),
                         torch.Generator().manual_seed(3))
    p = {n: jnp.asarray(t.numpy()) for n, t in layer.named_parameters()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((len(pad_lens), S, cfg.d_model)) \
        .astype(np.float32)
    pad = rng.standard_normal(cfg.d_model).astype(np.float32)
    for b, n in enumerate(pad_lens):
        x[b, S - n:] = pad
    top_i, keep = _ref_route(p, jnp.asarray(x), cfg)
    _, got_i, got_keep, _ = moe.route(layer, torch.tensor(x), _port_cfg(cfg))
    np.testing.assert_array_equal(got_i.numpy(), top_i)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    assert (~keep).any() == drops
    want, waux = jax.jit(lambda x: jax_moe.moe_forward(p, x, cfg))(
        jnp.asarray(x))
    got, aux = moe.moe_forward(layer, torch.tensor(x), _port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)
    if drops:   # a token whose every assignment dropped comes out 0
        gone = ~keep.reshape(keep.shape[0], S, cfg.top_k).any(-1)
        assert gone.any() and (got.numpy()[gone] == 0).all()


# ---------------------------------------------------------- the decoder
def test_dense_decoder_matches_reference(moe_tier):
    """Prefill of PAD-padded rows, then two decode steps: logits and both
    K/V slabs after each call."""
    m, p, bundle, port = moe_tier
    rng = np.random.default_rng(2)
    toks = rng.integers(4, MOE.vocab_size, (3, 11)).astype(np.int32)
    toks[1, 7:] = 0
    toks[2, 3:] = 0
    jl, jc = jax.jit(lambda t: m.prefill(p, {"tokens": t}, 14))(
        jnp.asarray(toks))
    tl, tc = bundle.prefill(port, {"tokens": torch.tensor(toks)}, 14)
    step = jax.jit(lambda c, t: m.decode_step(p, c, t))
    for i in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"call {i}")
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL, err_msg=f"call {i}: {k}")
        tok = rng.integers(4, MOE.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = step(jc, jnp.asarray(tok))
        tl, tc = bundle.decode_step(port, tc, torch.tensor(tok))


def test_paged_decoder_matches_reference(moe_tier):
    """Two prefill chunks (ragged, the second mid-context), two decode
    steps (the second with an idle slot) and a verify chunk: logits,
    hidden states and both page pools after every call (all but the
    scratch page)."""
    m, p, bundle, port = moe_tier
    cfg, pcfg = m.cfg, bundle.cfg
    ps, P, C = 8, 8, 8
    pt = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    rng = np.random.default_rng(1)
    jcache = jax_decoder.init_paged_decode_cache(cfg, P, ps)
    tcache = bundle.init_paged_cache(P, ps, device="cpu")
    prefill = jax.jit(lambda c, t, s, n: m.prefill_paged_chunk(
        p, c, t, jnp.asarray(pt), s, n, pages_bound=2))
    decode = jax.jit(lambda c, t, sl, a: m.decode_step_paged(
        p, c, t, jnp.asarray(pt), sl, a, pages_bound=4))
    verify = jax.jit(lambda c, t, s, n: m.verify_paged_chunk(
        p, c, t, jnp.asarray(pt), s, n, pages_bound=4))
    T = torch.tensor

    def check(jl, tl, what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=what)
        for k in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tcache[k][:, 1:].numpy(),
                                       np.asarray(jcache[k])[:, 1:],
                                       atol=ATOL, err_msg=f"{what}: {k}")

    start = np.zeros(2, np.int32)
    for n_new in (np.array([8, 5], np.int32), np.array([4, 7], np.int32)):
        toks = rng.integers(4, cfg.vocab_size, (2, C)).astype(np.int32)
        x, jcache = prefill(jcache, jnp.asarray(toks), jnp.asarray(start),
                            jnp.asarray(n_new))
        tx = bundle.prefill_paged_chunk(port, tcache, T(toks), T(pt),
                                        T(start), T(n_new), pages_bound=2)
        check(m.lm_head(p, x), bundle.lm_head(port, tx),
              f"prefill chunk at {start}")
        start = start + n_new
    lens = start.copy()
    for active in (np.array([True, True]), np.array([True, False])):
        toks = rng.integers(4, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = decode(jcache, jnp.asarray(toks), jnp.asarray(lens),
                            jnp.asarray(active))
        tl = bundle.decode_step_paged(port, tcache, T(toks), T(pt), T(lens),
                                      T(active), pages_bound=4)
        check(jl, tl, f"decode at {lens}")
        lens = lens + active
    n_new = np.array([5, 3], np.int32)
    toks = rng.integers(4, cfg.vocab_size, (2, 5)).astype(np.int32)
    jx, jcache = verify(jcache, jnp.asarray(toks), jnp.asarray(lens),
                        jnp.asarray(n_new))
    tx = bundle.verify_paged_chunk(port, tcache, T(toks), T(pt), T(lens),
                                   T(n_new), pages_bound=4)
    for b, n in enumerate(n_new):   # rows past n_new are PAD garbage
        np.testing.assert_allclose(tx[b, :n].numpy(), np.asarray(jx)[b, :n],
                                   atol=ATOL, err_msg=f"verify row {b}")
    check(m.lm_head(p, jx)[:, 0], bundle.lm_head(port, tx)[:, 0], "verify")


def check_forward_and_grads(tier, tokens, aux_weight=0.01):
    """Teacher-forced logits and aux against the reference's, and the
    gradient of xent + ``aux_weight`` * aux with respect to every
    parameter against ``jax.grad`` on the same batch. Returns the
    reference's aux."""
    m, p, bundle, model = tier
    cfg = bundle.cfg
    labels = np.roll(tokens, -1, axis=1)

    def jloss(p):
        logits, aux = m.forward(p, {"tokens": jnp.asarray(tokens)})
        loss = jax_softmax_xent(logits, jnp.asarray(labels))
        return loss + aux_weight * aux, (logits, aux)

    (jtot, (jlogits, jaux)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(p)
    params = dict(model.named_parameters())
    with trainable(model):
        logits, aux = bundle.forward(model, {"tokens": torch.tensor(tokens)})
        tot = softmax_xent(logits, torch.tensor(labels)) + aux_weight * aux
        grads = torch.autograd.grad(tot, list(params.values()))
    V = cfg.vocab_size
    np.testing.assert_allclose(logits.detach()[..., :V].numpy(),
                               np.asarray(jlogits)[..., :V], atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=AUX_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    want = bridge._state_from_tree(_np_tree(jgrads), cfg.n_layers)
    assert want.keys() == params.keys()
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_ATOL,
                                   err_msg=name)
    return float(jaux)


def test_forward_aux_and_grads_match_reference(moe_tier):
    tokens = np.random.default_rng(5).integers(
        4, MOE.vocab_size, (3, 12)).astype(np.int32)
    assert check_forward_and_grads(moe_tier, tokens) > 0.0


def test_window_moe_stack_matches_reference():
    """A sliding-window stack with MoE layers builds (no verify chunk, as
    the reference's bundle), its forward and gradients match, and its
    continuous engine emits the reference dense engine's greedy tokens."""
    cfg = tiny_cfg("moe", name="window-moe", n_layers=3, sliding_window=6,
                   local_global_ratio=2, cache_layout="paged",
                   prefill_chunk=8)
    tier = _tier(cfg, 2)
    m, p, bundle, model = tier
    assert bundle.cfg.has_window_layers and bundle.verify_paged_chunk is None
    assert m.verify_paged_chunk is None
    tokens = np.random.default_rng(6).integers(
        4, cfg.vocab_size, (2, 14)).astype(np.int32)
    check_forward_and_grads(tier, tokens)
    q = np.random.default_rng(1).integers(4, 200, (4, 19)).astype(np.int32)
    want, want_len = JaxDense(m, p, max_new_tokens=8).serve(q)
    got, got_len = ContinuousEngine(bundle, model, max_new_tokens=8,
                                    n_slots=2, max_seq=64,
                                    page_size=4).serve(q)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_len, np.asarray(want_len))


# ------------------------------------------------------------- engines
def test_engines_match_reference(moe_tier):
    """Ragged prompts through the continuous engine (2 slots, chunked and
    packed prefill, slot reuse) against the reference's, with the same
    counters; uniform prompts through the dense Engine against the
    reference's and against the port's continuous engine (greedy tokens
    exactly equal)."""
    m, p, bundle, model = moe_tier
    rng = np.random.default_rng(8)
    prompts = [rng.integers(4, MOE.vocab_size, (n,)).astype(np.int32)
               for n in (3, 17, 1, 9, 12, 6)]
    # pages of 16 tokens keep the reference's decode walks (and so its
    # compiles) few
    kw = dict(max_new_tokens=8, n_slots=2, page_size=16, max_seq=32)
    outs = []
    for eng in (_synchronous(JaxEngine(m, p, **kw)),
                ContinuousEngine(bundle, model, **kw)):
        reqs = [eng.submit(t, max_new_tokens=c)
                for t, c in zip(prompts, (4, 8, 6, 2, 8, 5))]
        eng.run()
        outs.append(([r.out for r in reqs], eng.stats))
    (want, ref_stats), (got, stats) = outs
    assert got == want
    for f in ("prefill_tokens", "decode_tokens", "prefill_chunks",
              "prefill_dispatches", "decode_steps", "steps"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    q = rng.integers(4, MOE.vocab_size, (5, 13)).astype(np.int32)
    want, want_len = JaxDense(m, p, max_new_tokens=6).serve(q)
    dense, dense_len = Engine(bundle, model, max_new_tokens=6).serve(q)
    cont, cont_len = ContinuousEngine(bundle, model, max_new_tokens=6,
                                      n_slots=2, max_seq=32,
                                      page_size=4).serve(q)
    for got, lens in ((dense, dense_len), (cont, cont_len)):
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(lens, np.asarray(want_len))


# ------------------------------------------------------------ training
def test_train_lm_on_a_moe_tier_matches_reference(moe_tier):
    """A ``train_lm`` step and a ``make_lm_train_step`` step on the rows
    ``train_lm`` draws first: loss, aux (weighed by ``aux_weight``) and
    grad norm against the reference's step on the same weights."""
    m, p, bundle, _ = moe_tier
    arrays = lm_training_arrays(generate_dataset(np.random.default_rng(0),
                                                 40))
    idx = np.random.default_rng(3).integers(0, 40, size=8)
    batch = {k: v[idx] for k, v in arrays.items()}
    ocfg = dict(lr=2e-3, warmup_steps=1, total_steps=1)
    _, _, want = jax_train_step(m, JaxAdamWConfig(**ocfg), 0.01)(
        p, jax_init_opt_state(p, JaxAdamWConfig(**ocfg)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    port = bridge.params_from_numpy(_np_tree(p), bundle.cfg, "cpu")
    with trainable(port):
        _, _, got = make_lm_train_step(bundle, AdamWConfig(**ocfg), 0.01)(
            port, init_opt_state(dict(port.named_parameters()),
                                 AdamWConfig(**ocfg)),
            {k: torch.tensor(v) for k, v in batch.items()})
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(got["aux"]) > 0.0
    port = bridge.params_from_numpy(_np_tree(p), bundle.cfg, "cpu")
    _, hist = train_lm(bundle, arrays, TrainConfig(
        steps=1, batch_size=8, lr=2e-3, log_every=1, seed=3), params=port)
    np.testing.assert_allclose(hist[0]["loss"], float(want["loss"]),
                               rtol=LOSS_RTOL)

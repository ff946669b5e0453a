"""bfloat16 through the port's SSM, hybrid, MoE, encoder-decoder and vision
paths against the JAX package, on the CPU, at ``tiny_cfg`` scale and on
the reference's bf16 weights through the bridge: the SSD chunk scan's
plain version (K3) against the reference's Pallas kernel run in interpret
mode, K3's dtype rule, the bf16 twin of an fp32 module
(``bridge.twin``, ``bridge.init_twin``), teacher-forced logits, the MoE
gate's expert choices, and serving (the SSM engines and pool, the
continuous == dense contract, ``build_generate_fn`` for the audio and
vision families). The card's bf16 K3 is held against the same plain
version in ``test_torch_gpu.py`` and ``chip_smoke.py``."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.routing import HybridRouter as JaxRouter
from repro.core.routing import ThresholdPolicy as JaxThresholdPolicy
from repro.data.tasks import generate_dataset
from repro.kernels.ssd_scan.kernel import ssd_chunk_scan as jax_ssd_kernel
from repro.kernels.ssd_scan.ops import ssd_chunk as jax_ssd_chunk
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.models import moe as jax_moe
from repro.models.frontends import make_batch as jax_make_batch
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro.serving import Engine as JaxDenseEngine
from repro.serving.generate import build_generate_fn as jax_generate_fn
from repro_torch import bridge
from repro_torch.core.routing import HybridRouter, ThresholdPolicy
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import moe as port_moe
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.serving.generate import build_generate_fn
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg
from test_torch_bf16 import LOGIT_ATOL, _bf16, _np_tree, _same_tokens, _tier
from test_torch_serving import RefEngines

# the reference's own tolerance for its SSD kernel against its oracle
# (tests/test_kernels.py::test_ssd_kernel_sweep); the plain version's gap
# to the interpret-mode kernel at bf16 inputs is about 1e-6 (fp32
# arithmetic on the same exact values, summed in another order)
SSD_TOL = 2e-4
# tests/test_kernels.py::test_ssd_kernel_sweep's shapes: (l, H, P, N)
SSD_SWEEP = [(16, 2, 8, 8), (32, 4, 16, 8), (64, 3, 32, 16)]
# the parameters a bf16 SSM config keeps in fp32, in the reference
# (models/ssm.py::init_ssm) and in the port (models/ssm.py::SSM)
FP32_LEAVES = {"A_log", "D", "dt_bias"}


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(a):
    """A reference array as a CPU tensor, bf16 bits kept."""
    return bridge.tensor_from_numpy(np.asarray(a))


# ------------------------------------------------------------------ K3
def _ssd_inputs(l, H, P, N, bc=4):
    """The sweep's draws with x, B and C in bf16 and dt, dA = cumsum(dt A)
    in fp32, as the reference's ``ssd_chunked`` passes them at a bf16
    config: (jax arrays, torch tensors) of the same bits."""
    rng = np.random.default_rng(l + H)
    jx, x = _bf16(rng, bc, H, l, P)
    dt = rng.uniform(0.01, 0.2, (bc, H, l, 1)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    da = np.cumsum(dt * A[None, :, None, None], axis=2, dtype=np.float32)
    (jB, B), (jC, C) = _bf16(rng, bc, l, N), _bf16(rng, bc, l, N)
    return ((jx, jnp.asarray(dt), jnp.asarray(da), jB, jC),
            (x, torch.tensor(dt), torch.tensor(da), B, C))


def _close_fp32(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SSD_TOL,
                                   atol=SSD_TOL)


@pytest.mark.parametrize("l,H,P,N", SSD_SWEEP)
def test_ssd_plain_version_matches_reference_kernel_at_bf16(l, H, P, N):
    """K3's plain version against the reference's Pallas kernel in
    interpret mode, x, B and C at bf16: the kernel layout
    (``ssd_chunk_scan``) and the model layout (``ssd_chunk`` against the
    reference's ``ssd_chunk``), fp32 outputs on both sides."""
    jargs, args = _ssd_inputs(l, H, P, N)
    _close_fp32(ssd_ops.ssd_chunk_scan(*args),
                jax_ssd_kernel(*jargs, interpret=True))
    # the model layout: (b, nc, l, H, P) with b * nc = bc
    model = lambda t, mv: mv(t).reshape((2, 2) + tuple(mv(t).shape[1:]))
    jx, jdt, jda, jB, jC = jargs
    jm = (model(jx, lambda t: jnp.moveaxis(t, 1, 2)),
          model(jdt[..., 0], lambda t: jnp.moveaxis(t, 1, 2)),
          model(jda[..., 0], lambda t: jnp.moveaxis(t, 1, 2)),
          model(jB, lambda t: t), model(jC, lambda t: t))
    _close_fp32(ssd_ops.ssd_chunk(*map(_port, jm)), jax_ssd_chunk(*jm))


F32, BF, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("x,dt,da,B,C,want", [
    (F32, F32, F32, F32, F32, F32),
    (BF, F32, F32, BF, BF, BF),
    (F16, F32, F32, F16, F16, None),          # fp16: never the reference's
    (BF, F32, F32, F32, BF, None),            # x, B and C mixed
    (F32, F32, F32, BF, BF, None),
    (BF, BF, F32, BF, BF, None),              # a bf16 dt
    (BF, F32, BF, BF, BF, None),              # a bf16 dA
    (F32, BF, BF, F32, F32, None),
])
def test_ssd_dtype_rule(x, dt, da, B, C, want):
    """K3's dtype rule, a pure function of the dtypes (what its wrapper
    checks on the card before a launch): x, B and C one of fp32 and bf16,
    dt and dA fp32; anything else raises."""
    if want is None:
        with pytest.raises(ValueError, match="mixed|the kernel takes"):
            ssd_ops.check_dtypes(x, dt, da, B, C)
    else:
        assert ssd_ops.check_dtypes(x, dt, da, B, C) is want


# ------------------------------------------------------------- the twin
def _bits(t):
    return t.detach().view(torch.int16 if t.dtype == BF else torch.int32)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_bf16_twin_keeps_the_reference_fp32_parameters(family):
    """``bridge.twin`` of an fp32 module at the bf16 config: ``A_log``,
    ``D`` and ``dt_bias`` stay fp32 (as the reference's bf16 config keeps
    them), every other parameter is bf16 and equals, bit for bit, what
    ``params_from_numpy`` loads at the bf16 config from the same
    reference tree; ``init_twin`` draws the twin of the fp32 init."""
    cfg = tiny_cfg(family)
    ref16 = jax.eval_shape(jax_build_model(dataclasses.replace(
        cfg, dtype="bfloat16")).init, jax.random.PRNGKey(0))
    assert {k[-1].key for k, v in jax.tree_util.tree_flatten_with_path(
        ref16)[0] if v.dtype == jnp.float32} == FP32_LEAVES
    p32 = ArchConfig(**dataclasses.asdict(cfg))
    p16 = dataclasses.replace(p32, dtype="bfloat16")
    fresh32 = build_model(p32).init(torch.Generator().manual_seed(0), "cpu")
    # the reference's tree of those fp32 weights (as its checkpoint holds it)
    tree = bridge.numpy_from_params(fresh32, p32)
    twin = bridge.twin(bridge.params_from_numpy(tree, p32, "cpu"), p16)
    loaded = bridge.params_from_numpy(tree, p16, "cpu")
    drawn = bridge.init_twin(p16, torch.Generator().manual_seed(0), "cpu")
    fresh = bridge.twin(fresh32, p16)
    names = [n for n, _ in twin.named_parameters()]
    assert names == [n for n, _ in loaded.named_parameters()]
    for (n, a), b, c, d in zip(twin.named_parameters(), loaded.parameters(),
                               drawn.parameters(), fresh.parameters()):
        want = F32 if n.rsplit(".", 1)[-1] in FP32_LEAVES else BF
        assert a.dtype == b.dtype == c.dtype == want, n
        assert torch.equal(_bits(a), _bits(b)), n
        assert torch.equal(_bits(c), _bits(d)), n


# ------------------------------------------------------------- forward
def _inputs(m, B=3, S=24, seed=4):
    """The reference's ``make_batch`` inputs (tokens and the family's
    stub embeddings, bf16 at a bf16 config): (jax batch, torch batch)."""
    batch = jax_make_batch(jax.random.PRNGKey(seed), m.cfg, B, S,
                           for_train=False)
    return batch, {k: _port(v) for k, v in batch.items()}


@pytest.mark.parametrize("family", ["ssm", "audio", "vlm"])
def test_teacher_forced_logits_match_reference_at_bf16(family):
    """The port's bf16 forward on the reference's bf16 weights and inputs
    (``enc_embeds``, ``frontend_embeds``): logits within LOGIT_ATOL of the
    reference's jitted forward (test_torch_bf16.py's bound: bf16 roundings
    of activations up to about 4 at other places), and the same argmax
    except where the reference's top-2 margin is under 2 LOGIT_ATOL."""
    m, p, bundle, model = _tier(tiny_cfg(family, dtype="bfloat16"), 0)
    batch, tbatch = _inputs(m)
    want, _ = jax.jit(m.forward)(p, batch)
    got, _ = bundle.forward(model, tbatch)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    V = bundle.cfg.vocab_size
    g, w = got[..., :V].float().numpy(), np.asarray(want, np.float32)[..., :V]
    np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(w, -1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] >= 2 * LOGIT_ATOL
    np.testing.assert_array_equal(g.argmax(-1)[sure], w.argmax(-1)[sure])


def test_hybrid_logits_within_the_references_own_gap():
    """The hybrid stack with routing made trivial (n_experts = top_k = 2,
    so no bf16 near-tie can move a token to another expert): the port's
    bf16 logits against the reference's jitted forward within twice the
    reference's own gap, its jitted forward against its op-by-op forward
    (``jax.disable_jit``) on the same weights and tokens, computed here.
    Two bf16 computations of the stack that round at other places differ
    by that gap (0.10 measured); the port is a third, as close to either
    (0.11-0.18 measured), so twice it bounds the port's distance."""
    m, p, bundle, model = _tier(tiny_cfg("hybrid", n_experts=2, top_k=2,
                                         dtype="bfloat16"), 0)
    tokens = np.random.default_rng(2).integers(4, 256, (3, 24)).astype(
        np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    jitted = np.asarray(jax.jit(m.forward)(p, batch)[0], np.float32)
    with jax.disable_jit():
        eager = np.asarray(m.forward(p, batch)[0], np.float32)
    V = bundle.cfg.vocab_size
    gap = np.abs(jitted - eager)[..., :V].max()
    got, _ = bundle.forward(model, {"tokens": torch.tensor(tokens)})
    err = np.abs(got.float().numpy() - jitted)[..., :V].max()
    assert 0 < gap and err <= 2 * gap, (err, gap)


def _reference_gates(m, p, batch):
    """Every MoE layer of the reference's jitted forward, in the order it
    runs them: (its input x (B, S, D) bf16, its gate weights, its gate
    logits (B, S, E) fp32), recorded by a callback around
    ``repro.models.moe.moe_forward``, where its decoder and hybrid stack
    call it."""
    rec = []
    forward = jax_moe.moe_forward

    def recorded(params, x, cfg):
        gate = (x @ params["w_gate_logits"]).astype(jnp.float32)
        jax.debug.callback(lambda *a: rec.append([np.asarray(t) for t in a]),
                           x, params["w_gate_logits"], gate, ordered=True)
        return forward(params, x, cfg)

    jax_moe.moe_forward = recorded
    try:
        jax.block_until_ready(jax.jit(m.forward)(p, batch))
    finally:
        jax_moe.moe_forward = forward
    return rec


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_expert_choices_match_reference_at_bf16(family):
    """MoE with real routing: a bf16 near-tie in the gate moves a token to
    another expert, and the reference's own jitted and op-by-op forwards
    differ by up to 0.86 in their logits for it, so no logit tolerance
    holds these stacks. Instead, at every MoE layer, on the input the
    reference's forward hands that layer: the port's gate logits within
    one bf16 rounding (half a unit in the last place) of the reference's,
    and the port's top-k experts the reference's, except where the
    reference's margin between its k-th and (k+1)-th logit is under the
    bf16 rounding of those logits (none, on these weights)."""
    m, p, bundle, model = _tier(tiny_cfg(family, dtype="bfloat16"), 0)
    tokens = np.random.default_rng(2).integers(4, 256, (3, 24)).astype(
        np.int32)
    rec = _reference_gates(m, p, {"tokens": jnp.asarray(tokens)})
    layers = [mod for mod in model.modules()
              if isinstance(mod, port_moe.MoE)]
    assert len(rec) == len(layers) > 0
    cfg, k = bundle.cfg, bundle.cfg.top_k
    for layer, (x, w, gate) in zip(layers, rec):
        assert torch.equal(_bits(layer.w_gate_logits), _bits(_port(w)))
        xt = _port(x)
        _, top_i, _, _ = port_moe.route(layer, xt, cfg)
        got_gate = (xt @ layer.w_gate_logits).float().numpy()
        half_ulp = np.abs(gate) * 2.0 ** -8
        assert (np.abs(got_gate - gate) <= half_ulp).all()
        s = np.sort(gate, -1)[..., ::-1]
        tie = s[..., k - 1] - s[..., k] < np.abs(s[..., k - 1]) * 2.0 ** -8
        want = np.sort(np.argsort(-gate, -1, kind="stable")[..., :k], -1)
        same = (np.sort(top_i.numpy(), -1) == want).all(-1)
        assert (same | tie).all(), np.argwhere(~same & ~tie)


# ------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def ssm():
    return _tier(tiny_cfg("ssm", dtype="bfloat16"), 0)


@pytest.fixture(scope="module")
def refs():
    return RefEngines()


# pages of 16 tokens, as the fp32 SSM serving tests take them
ENGINE_KW = dict(max_new_tokens=8, n_slots=2, page_size=16, max_seq=32,
                 prefill_chunk=16)


def _queries(vocab, n, L, seed):
    q = np.random.default_rng(seed).integers(4, vocab, (n, L)).astype(
        np.int32)
    return q


def test_ssm_engines_match_reference_at_bf16(ssm, refs):
    """The SSM ``ContinuousEngine`` (chunked prefill, packed rows,
    recurrent-state rows) and dense ``Engine`` on the reference's bf16
    weights against the reference's engines: the same lengths, and the
    same greedy tokens up to a near-tie (``_same_tokens``). The port's
    continuous and dense paths emit the same tokens as each other
    (the "continuous == dense" contract)."""
    m, p, bundle, model = ssm
    q = _queries(256, 5, 12, 0)
    q[1, 9:] = 0    # served as they are: the engines take whole rows
    q[3, 5:] = 0
    prompts = list(q)
    want = refs.get(m, p, **ENGINE_KW).serve(q)
    got = ContinuousEngine(bundle, model, **ENGINE_KW).serve(q)
    np.testing.assert_array_equal(got[1], want[1])
    # on these prompts one stream parts where the reference's top-2
    # margin is exactly 0 (a tie its bf16 logits cannot break)
    assert len(_same_tokens(m, p, prompts, got[0], want[0])) <= 1
    dwant = JaxDenseEngine(m, p, max_new_tokens=8).serve(q)
    dgot = Engine(bundle, model, max_new_tokens=8).serve(q)
    np.testing.assert_array_equal(dgot[1], dwant[1])
    assert len(_same_tokens(m, p, prompts, dgot[0], dwant[0])) <= 1
    np.testing.assert_array_equal(got[0], dgot[0])
    np.testing.assert_array_equal(got[1], dgot[1])


def test_hybrid_continuous_matches_dense_at_bf16():
    """The hybrid stack at bf16 (its Mamba layers' K3, attention, MoE
    every other layer) through the port's continuous engine and its dense
    ``Engine``: token for token (the "continuous == dense" contract,
    docs/architecture.md). The hybrid is held to the reference through
    its logits and expert choices above."""
    cfg = ArchConfig(**dataclasses.asdict(tiny_cfg("hybrid",
                                                    dtype="bfloat16")))
    bundle = build_model(cfg)
    model = bridge.init_twin(cfg, torch.Generator().manual_seed(0), "cpu")
    q = _queries(256, 3, 9, 1)
    rd, ld = Engine(bundle, model, max_new_tokens=5).serve(q)
    rc, lc = ContinuousEngine(bundle, model, max_new_tokens=5, n_slots=2,
                              max_seq=32, page_size=4).serve(q)
    np.testing.assert_array_equal(rc, rd)
    np.testing.assert_array_equal(lc, ld)


def test_two_tier_ssm_pool_routes_as_reference_at_bf16(ssm, refs):
    """Two bf16 SSM tiers behind an fp32 router (more requests than
    slots): every query on the reference's tier, the same scores and
    lengths, greedy tokens equal up to a near-tie."""
    small = _tier(tiny_cfg("ssm", name="ssm-small", n_layers=1, d_model=32,
                           dtype="bfloat16"), 1)
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(5),
                                                    rcfg)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    router = bridge.params_from_numpy(_np_tree(rp), prcfg, "cpu")
    ds = generate_dataset(np.random.default_rng(3), 8, q_len=12)
    scores = np.sort(np.asarray(JaxRouter(rp, rcfg, 0.0).scores(
        ds.query, ds.query_mask)))
    threshold = float(scores[3] + scores[4]) / 2   # 4 queries each side
    tiers = (small, ssm)
    ref = JaxPool(JaxThresholdPolicy(JaxRouter(rp, rcfg, threshold)),
                  [(n, refs.get(t[0], t[1], **ENGINE_KW))
                   for n, t in zip(("small", "large"), tiers)])
    want = ref.serve(ds.query, ds.query_mask)
    pool = ContinuousPoolEngine(
        ThresholdPolicy(HybridRouter(router, prcfg, threshold)),
        [(n, ContinuousEngine(t[2], t[3], **ENGINE_KW))
         for n, t in zip(("small", "large"), tiers)])
    got = pool.serve(ds.query, ds.query_mask)
    np.testing.assert_array_equal(got.tier_idx, want.tier_idx)
    assert 0 < got.tier_idx.sum() < len(got.tier_idx)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-6)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    prompts = [q[:int(n)] for q, n in zip(ds.query, ds.query_mask.sum(1))]
    for i, t in enumerate(got.tier_idx):
        n = int(got.lengths[i])
        m, p = tiers[t][:2]
        assert len(_same_tokens(m, p, [prompts[i]], [got.responses[i, :n]],
                                [want.responses[i, :n]])) <= 1
    for e in pool.engines:
        assert e.cache.free_pages == e.cache.num_pages - 1


def _generate_margin(m, p, batch, row, context):
    """The reference's top-2 margin of the next-token logits after
    ``context`` for ``row`` of ``batch`` (its frontend inputs kept),
    teacher-forced."""
    one = {k: v[row:row + 1] for k, v in batch.items()}
    one["tokens"] = jnp.asarray([context], jnp.int32)
    logits, _ = jax.jit(m.forward)(p, one)
    last = np.sort(np.asarray(logits[0, -1], np.float32))
    return float(last[-1] - last[-2])


@pytest.mark.parametrize("family", ["audio", "vlm"])
def test_generate_matches_reference_at_bf16(family):
    """``build_generate_fn`` at temperature 0 on the reference's bf16
    weights and ``make_batch`` inputs (bf16 stub embeddings): the same
    greedy tokens and lengths up to a first divergence, allowed only where
    the reference's top-2 margin there is under 2 LOGIT_ATOL."""
    m, p, bundle, model = _tier(tiny_cfg(family, dtype="bfloat16"), 0)
    batch, tbatch = _inputs(m, B=3, S=7)
    want, want_len = jax_generate_fn(m, 6, 0.0)(p, batch,
                                                jax.random.PRNGKey(0))
    got, got_len = build_generate_fn(bundle, 6, 0.0)(
        model, tbatch, torch.Generator().manual_seed(0))
    want = np.asarray(want)
    for row, (a, b) in enumerate(zip(got.numpy(), want)):
        if list(a) == list(b):
            assert int(got_len[row]) == int(want_len[row])
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        context = list(np.asarray(batch["tokens"][row])) + list(b[:j])
        margin = _generate_margin(m, p, batch, row, context)
        assert margin < 2 * LOGIT_ATOL, (family, row, j, margin)

"""bfloat16 through the port against the JAX package, on the CPU: the four
attention kernels' plain versions (K1, K2, K4, K5) against the reference's
oracles (``ref.py``, which its own tests hold its Pallas kernels to at
bf16) at the reference tests' bf16 shapes and tolerance, the weight bridge
bit for bit both ways (``ml_dtypes`` arrays and a bf16 ``.npz`` written by
the reference's ``save_checkpoint``), teacher-forced logits, the dense
``Engine`` and the two-tier continuous pool on the reference's bf16
weights, and the kernels' dtype rule (``kernels.common.float_dtype``).
The card's bf16 kernels are held against these plain versions in
``test_torch_gpu.py`` and ``chip_smoke.py``."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.routing import HybridRouter as JaxRouter
from repro.core.routing import ThresholdPolicy as JaxThresholdPolicy
from repro.data.tasks import generate_dataset
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged_decode_attention.ref import \
    paged_decode_attention_ref
from repro.kernels.paged_prefill_attention.ref import \
    paged_prefill_attention_ref
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro.serving import Engine as JaxDenseEngine
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch import bridge
from repro_torch.core.routing import HybridRouter, ThresholdPolicy
from repro_torch.kernels.common import float_dtype
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_decode_attention import ops as pdec_ops
from repro_torch.kernels.paged_prefill_attention import ops as ppre_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.serving.pool import ContinuousPoolEngine
from repro_torch.training.checkpoint import load_checkpoint
from conftest import tiny_cfg
from test_torch_serving import _synchronous

BF = jnp.bfloat16
# the reference's oracles, jitted (its eager dispatch is slow on the CPU)
jax_flash = jax.jit(attention_ref, static_argnames=("causal", "window"))
jax_dec = jax.jit(decode_attention_ref)
jax_paged_dec = jax.jit(paged_decode_attention_ref)
jax_paged_pre = jax.jit(paged_prefill_attention_ref)
# the reference's own bf16 tolerance for its kernels against their oracles
# (tests/test_kernels.py, test_paged_kernel.py, test_chunked_prefill.py)
KERNEL_TOL = 2e-2
# bf16 logits of the 2-layer tiny model, port against reference: bf16
# keeps 8 significant bits, so each rounding of an activation of up to ~4
# moves it by up to 2^-8 * 4 = 0.016, and the two frameworks round at
# other places (XLA keeps fused elementwise chains in fp32). The reference
# disagrees with itself by as much: its jitted and its op-by-op forward
# differ by 0.055 on these weights.
LOGIT_ATOL = 0.1


def _bf16(rng, *shape, scale=1.0):
    """A bf16 array drawn from ``rng``: (jax array, torch tensor), the
    same bits on both sides (through the bridge's bf16 view)."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, BF)
    return a, bridge.tensor_from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("S,H,D", [(128, 2, 32), (256, 4, 64), (512, 1, 128)])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_plain_version_matches_reference_at_bf16(S, H, D, window):
    """K4's plain version in the model layout against the reference's
    oracle (tests/test_kernels.py's sweep)."""
    rng = np.random.default_rng(S + H + window)
    B = 2
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, B, S, H, D, scale=s)
                                 for s in (D ** -0.5, 1.0, 1.0))
    got = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    bhsd = lambda t: jnp.moveaxis(t, 2, 1).reshape(B * H, S, D)
    want = jnp.moveaxis(jax_flash(bhsd(jq), bhsd(jk), bhsd(jv), causal=True,
                                  window=window).reshape(B, H, S, D), 1, 2)
    _close(got, want)


@pytest.mark.parametrize("S,G,D,bk", [(512, 1, 64, 128), (1024, 4, 64, 512),
                                      (2048, 12, 128, 512)])
def test_dense_decode_plain_version_matches_reference_at_bf16(S, G, D, bk):
    """K5's plain version (the TPU kernel's contract) against the
    reference's oracle (tests/test_kernels.py's sweep; ``bk`` is its
    kernel's key block, which the oracle does not take)."""
    rng = np.random.default_rng(S + G)
    BK = 3
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, BK, n, D, scale=s)
                                 for n, s in ((G, D ** -0.5), (S, 1.0),
                                              (S, 1.0)))
    valid = rng.integers(0, 2, (BK, S)).astype(np.int8)
    valid[:, 0] = 1
    got = dec_ops.decode_attention_gqa(q, k, v, torch.tensor(valid))
    assert got.dtype == torch.bfloat16
    _close(got, jax_dec(jq, jk, jv, jnp.asarray(valid)))


def _pool(rng, B, K, D, ps, MP, totals):
    """A bf16 page pool and a table giving each request distinct pages
    covering ``totals[b]`` tokens (page 0 scratch), as the reference's
    tests make them."""
    n_pages = 1 + sum(-(-int(t) // ps) for t in totals)
    kp, vp = (_bf16(rng, n_pages, ps, K, D) for _ in range(2))
    pt = np.zeros((B, MP), np.int32)
    nxt = 1
    for b in range(B):
        n = -(-int(totals[b]) // ps)
        pt[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return kp, vp, pt


@pytest.mark.parametrize("G,ps,D", [(1, 8, 32), (2, 16, 64), (4, 8, 128),
                                    (8, 32, 32)])
def test_paged_decode_plain_version_matches_reference_at_bf16(G, ps, D):
    """K1's plain version against the reference's oracle
    (tests/test_paged_kernel.py's sweep)."""
    rng = np.random.default_rng(G * ps + D)
    B, K, MP = 3, 2, 6
    lens = rng.integers(1, MP * ps + 1, (B,)).astype(np.int32)
    jq, q = _bf16(rng, B, K, G, D, scale=D ** -0.5)
    (jkp, kp), (jvp, vp), pt = _pool(rng, B, K, D, ps, MP, lens)
    got = pdec_ops.paged_decode_attention_gqa(q, kp, vp, torch.tensor(pt),
                                              torch.tensor(lens))
    assert got.dtype == torch.bfloat16
    _close(got, jax_paged_dec(jq, jkp, jvp, jnp.asarray(pt),
                              jnp.asarray(lens)))


@pytest.mark.parametrize("G,ps,D,C", [(1, 8, 32, 4), (2, 16, 64, 8),
                                      (4, 8, 128, 16), (8, 32, 32, 5)])
def test_paged_prefill_plain_version_matches_reference_at_bf16(G, ps, D, C):
    """K2's plain version against the reference's oracle
    (tests/test_chunked_prefill.py's sweep)."""
    rng = np.random.default_rng(G * ps + D + C)
    B, K, MP = 3, 2, 6
    total = rng.integers(1, MP * ps + 1, (B,))
    n_new = np.minimum(total, rng.integers(1, C + 1, (B,)))
    start = (total - n_new).astype(np.int32)
    total = total.astype(np.int32)
    jq, q = _bf16(rng, B, K, C, G, D, scale=D ** -0.5)
    (jkp, kp), (jvp, vp), pt = _pool(rng, B, K, D, ps, MP, total)
    got = ppre_ops.paged_prefill_attention_gqa(
        q, kp, vp, torch.tensor(pt), torch.tensor(start), torch.tensor(total))
    assert got.dtype == torch.bfloat16
    _close(got, jax_paged_pre(jq, jkp, jvp, jnp.asarray(pt),
                              jnp.asarray(start), jnp.asarray(total)))


@pytest.mark.parametrize("dtypes,want", [
    ((torch.float32,) * 3, torch.float32),
    ((torch.bfloat16,) * 3, torch.bfloat16),
    ((torch.bfloat16, torch.float32, torch.bfloat16), None),
    ((torch.float16,) * 3, None),
    ((torch.float64,) * 3, None),
])
def test_kernel_dtype_rule(dtypes, want):
    """Every float input of a launch fp32, or every one bf16; a mix, fp16
    (which the reference never tests) or fp64 raises. A pure function of
    the dtypes: the rule the wrappers apply on the card before a launch."""
    named = dict(zip(("q", "k", "v"), dtypes))
    if want is None:
        with pytest.raises(ValueError, match="mixed|the kernel takes"):
            float_dtype("probe", named)
    else:
        assert float_dtype("probe", named) is want
    # a launch whose floats must be fp32 (the SSD scan's dt and dA) names
    # that dtype alone
    with pytest.raises(ValueError, match="the kernel takes torch.float32$"):
        float_dtype("ssd", {"x": torch.bfloat16}, (torch.float32,))


# ----------------------------------------------------------------- bridge
def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tier(cfg, seed):
    """(reference bundle, its bf16 params, port bundle, port model): the
    reference's bf16 weights through the bridge."""
    m = jax_build_model(cfg)
    p = jax.jit(m.init)(jax.random.PRNGKey(seed))
    pcfg = ArchConfig(**dataclasses.asdict(cfg))
    return m, p, build_model(pcfg), bridge.params_from_numpy(_np_tree(p),
                                                             pcfg, "cpu")


@pytest.fixture(scope="module")
def dense():
    return _tier(tiny_cfg("dense", dtype="bfloat16"), 0)


def _bits(a):
    """The 16 bits of each bf16 value: of an ml_dtypes or V2 array, or of
    a torch bf16 tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def test_bridge_carries_bf16_bit_for_bit(dense, tmp_path):
    """The reference's bf16 params into bf16 parameters bit for bit, from
    its ml_dtypes arrays and from the .npz its save_checkpoint writes
    (read back as 2-byte records); back through ``numpy_from_params`` as
    fp32 arrays holding the same values, which the reference's cast to
    bf16 returns to the same bits; and into an fp32 model exactly."""
    _, p, bundle, model = dense
    flat = {".".join(k): v for k, v in _flat(_np_tree(p)).items()}
    assert all(a.dtype.name == "bfloat16" for a in flat.values())
    state = dict(model.named_parameters())
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    # the stacked reference tree, as the bridge reads it
    tree = bridge._state_from_tree(_np_tree(p), bundle.cfg.n_layers)
    for name, t in state.items():
        np.testing.assert_array_equal(_bits(t.detach()), _bits(tree[name]))
    path = tmp_path / "bf16.npz"
    jax_save(str(path), p)
    loaded = load_checkpoint(str(path))
    assert {a.dtype.kind for a in _flat(loaded).values()} == {"V"}
    again = bridge.params_from_numpy(loaded, bundle.cfg, "cpu")
    for (name, a), b in zip(again.named_parameters(), state.values()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name
    back = bridge.numpy_from_params(model, bundle.cfg)
    for key, arr in _flat(back).items():
        assert arr.dtype == np.float32, key
        np.testing.assert_array_equal(
            _bits(jnp.asarray(arr, BF)), _bits(_flat(_np_tree(p))[key]))
    fp32 = bridge.params_from_numpy(
        _np_tree(p), dataclasses.replace(bundle.cfg, dtype="float32"), "cpu")
    for (name, a), b in zip(fp32.named_parameters(), state.values()):
        assert a.dtype == torch.float32 and torch.equal(a, b.float()), name


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------- serving
def test_teacher_forced_logits_match_reference_at_bf16(dense):
    """The port's bf16 forward on the reference's bf16 weights: bf16
    logits within LOGIT_ATOL of the reference's, the same argmax at every
    position, the padded tail masked alike."""
    m, p, bundle, model = dense
    tokens = np.random.default_rng(2).integers(4, 256, (3, 24)).astype(
        np.int32)
    want, _ = jax.jit(m.forward)(p, {"tokens": jnp.asarray(tokens)})
    got, _ = bundle.forward(model, {"tokens": torch.tensor(tokens)})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    V = bundle.cfg.vocab_size
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got[..., :V].float().numpy(), w[..., :V],
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(got[..., :V].float().argmax(-1).numpy(),
                                  w[..., :V].argmax(-1))
    np.testing.assert_array_equal(got[..., V:].float().numpy(), w[..., V:])


def _margin(m, p, context):
    """The reference's top-2 margin of the next-token logits after
    ``context`` (teacher-forced)."""
    logits, _ = jax.jit(m.forward)(
        p, {"tokens": jnp.asarray([context], jnp.int32)})
    last = np.sort(np.asarray(logits[0, -1], np.float32))
    return float(last[-1] - last[-2])


def _same_tokens(m, p, prompts, got, want):
    """Greedy tokens equal, stream by stream, up to a first divergence
    only where the reference's top-2 margin there is under 2 LOGIT_ATOL
    (logits within LOGIT_ATOL of each other cannot order two tokens
    differently past that); returns the streams that diverged."""
    diverged = []
    for prompt, a, b in zip(prompts, got, want):
        if list(a) == list(b):
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = _margin(m, p, list(prompt) + list(b[:j]))
        assert margin < 2 * LOGIT_ATOL, (j, margin, a, b)
        diverged.append((j, margin))
    return diverged


def test_dense_engine_matches_reference_at_bf16(dense):
    """The dense ``Engine`` on the reference's bf16 weights: the same
    lengths as the reference's, and the same greedy tokens up to a
    near-tie (``_same_tokens``)."""
    m, p, bundle, model = dense
    rng = np.random.default_rng(0)
    q = rng.integers(4, 256, (5, 12)).astype(np.int32)
    q[1, 9:] = 0
    q[3, 5:] = 0
    want = JaxDenseEngine(m, p, max_new_tokens=8).serve(q)
    got = Engine(bundle, model, max_new_tokens=8).serve(q)
    np.testing.assert_array_equal(got[1], want[1])
    # on these prompts one stream parts at a near-tie (the reference's
    # top-2 margin there 0.0156, one bf16 step at that magnitude)
    assert len(_same_tokens(m, p, q, got[0], want[0])) <= 1


def test_two_tier_pool_matches_reference_at_bf16(dense):
    """Two bf16 tiers behind an fp32 router (the reference's bf16 weights,
    more requests than slots): the same tier for every query, the same
    scores and lengths, and the same greedy tokens on every stream."""
    small = _tier(tiny_cfg("dense", name="small", n_layers=1, d_model=32,
                           n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                           dtype="bfloat16"), 1)
    large = dense
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(5),
                                                    rcfg)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    router = bridge.params_from_numpy(_np_tree(rp), prcfg, "cpu")
    ds = generate_dataset(np.random.default_rng(3), 8, q_len=16)
    scores = np.sort(np.asarray(JaxRouter(rp, rcfg, 0.0).scores(
        ds.query, ds.query_mask)))
    threshold = float(scores[3] + scores[4]) / 2   # 4 queries each side
    kw = dict(max_new_tokens=6, n_slots=3, max_seq=32, prefill_chunk=8)
    ref = JaxPool(JaxThresholdPolicy(JaxRouter(rp, rcfg, threshold)),
                  [("small", _synchronous(JaxEngine(small[0], small[1],
                                                    **kw))),
                   ("large", _synchronous(JaxEngine(large[0], large[1],
                                                    **kw)))])
    want = ref.serve(ds.query, ds.query_mask)
    pool = ContinuousPoolEngine(
        ThresholdPolicy(HybridRouter(router, prcfg, threshold)),
        [("small", ContinuousEngine(small[2], small[3], **kw)),
         ("large", ContinuousEngine(large[2], large[3], **kw))])
    got = pool.serve(ds.query, ds.query_mask)
    np.testing.assert_array_equal(got.tier_idx, want.tier_idx)
    assert 0 < got.tier_idx.sum() < len(got.tier_idx)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-6)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    prompts = [q[:int(n)] for q, n in zip(ds.query,
                                           ds.query_mask.sum(1))]
    tiers = (small, large)
    for i, t in enumerate(got.tier_idx):
        n = int(got.lengths[i])
        m, p = tiers[t][:2]
        assert _same_tokens(m, p, [prompts[i]], [got.responses[i, :n]],
                            [want.responses[i, :n]]) == []
    for e in pool.engines:
        assert e.cache.free_pages == e.cache.num_pages - 1

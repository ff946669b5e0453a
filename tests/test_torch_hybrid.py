"""The port's hybrid (Jamba) family and the SSM teacher-forced forward
against the JAX package on bridged weights: the block layout, the bridge's
two-axis ``blocks`` tree, every entry point of ``models/hybrid.py`` (the
teacher-forced forward with its aux and gradients, dense prefill and
decode, multi-chunk paged prefill and paged decode, with fresh-row and
inactive-row cases), the engine's refusals, ``ssm_forward`` and the SSM
``decoder_forward`` with their gradients, and the three published
MoE/hybrid configs. fp32 at "highest" matmul precision on both sides. The
serving paths are in tests/test_torch_hybrid_serving.py."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.grok_1_314b import CONFIG as JAX_GROK
from repro.configs.jamba_v01_52b import CONFIG as JAX_JAMBA
from repro.configs.phi35_moe_42b import CONFIG as JAX_PHI
from repro.models import hybrid as jax_hybrid
from repro.models import ssm as jax_ssm
from repro.serving import ContinuousEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs.grok_1_314b import CONFIG as GROK
from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA
from repro_torch.configs.phi35_moe_42b import CONFIG as PHI
from repro_torch.models import hybrid, ssm
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine
from conftest import tiny_cfg
from test_torch_moe import check_forward_and_grads
from test_torch_serving import (_np_tree, _tier,  # noqa: F401
                                highest_precision)

ATOL = 1e-4    # logits, hidden states, K/V, state slabs: fp32

HYBRID = tiny_cfg("hybrid", cache_layout="paged", prefill_chunk=8)


@pytest.fixture(scope="module")
def jamba():
    return _tier(HYBRID, 0)


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


# ------------------------------------------------------- layout, bridge
def test_block_layout_matches_reference():
    """One attention layer a block at offset 4, MoE at the odd positions
    (tests/test_models.py::test_jamba_block_layout), the same per-layer
    kinds as the reference's config, and the modules' counts."""
    for cfg in (HYBRID, JAX_JAMBA):
        pcfg = _port_cfg(cfg)
        assert hybrid._block_layout(pcfg) == jax_hybrid._block_layout(cfg)
        kinds = [pcfg.layer_kind(i) for i in range(8)]
        assert kinds == [cfg.layer_kind(i) for i in range(8)]
        assert sum(k["attn"] for k in kinds) == 1 and kinds[4]["attn"]
        assert sum(k["moe"] for k in kinds) == 4
    model = hybrid.Hybrid(_port_cfg(HYBRID), "meta")
    block = model.blocks[0]
    assert (len(model.blocks), len(block.mamba), len(block.moe),
            len(block.mlp)) == (1, 7, 4, 4)


def test_bridge_round_trip_and_raises(jamba):
    """The reference's tree loads (two leading axes under ``blocks/``, one
    under ``blocks/attn``) and comes back equal; a missing tensor, a
    sub-layer count that does not fit and a mis-shaped tensor raise."""
    m, p, bundle, model = jamba
    tree = _np_tree(p)
    assert tree["blocks"]["mamba"]["ssm"]["w_in"].shape[:2] == (1, 7)
    assert tree["blocks"]["attn"]["attn"]["wq"].shape[0] == 1
    back = bridge.numpy_from_params(model, bundle.cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    np.testing.assert_array_equal(
        model.blocks[0].moe[3].moe.w_out.numpy(),
        tree["blocks"]["moe"]["moe"]["w_out"][0, 3])
    cfg = bundle.cfg
    bad = _np_tree(p)
    del bad["blocks"]["moe"]["ln2"]
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_numpy(bad, cfg, "cpu")
    bad = _np_tree(p)
    bad["blocks"]["mamba"]["ln"]["scale"] = \
        bad["blocks"]["mamba"]["ln"]["scale"][:, :6]
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_numpy(bad, cfg, "cpu")
    bad = _np_tree(p)
    bad["blocks"]["attn"]["ln1"]["scale"] = \
        bad["blocks"]["attn"]["ln1"]["scale"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(bad, cfg, "cpu")


# -------------------------------------------------------------- forward
def test_hybrid_forward_aux_and_grads_match_reference(jamba):
    tokens = np.random.default_rng(5).integers(
        4, HYBRID.vocab_size, (2, 13)).astype(np.int32)
    assert check_forward_and_grads(jamba, tokens) > 0.0


def test_ssm_forward_matches_reference():
    """The mixer alone, S past one SSD chunk and not a multiple of it:
    the output, and the gradient of its sum of squares with respect to
    the input and every weight, against ``jax.grad``; the SSM decoder's
    teacher-forced forward with its gradients
    (``check_forward_and_grads``)."""
    tier = _tier(tiny_cfg("ssm"), 1)
    m, p, bundle, model = tier
    cfg, pcfg = m.cfg, bundle.cfg
    x = np.random.default_rng(2).standard_normal((2, 21, cfg.d_model)) \
        .astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0], p["layers"]["ssm"])

    def jloss(lp, x):
        y = jax_ssm.ssm_forward(lp, x, cfg)
        return jnp.sum(y * y), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
    mixer = model.layers[0].ssm
    xt = torch.tensor(x, requires_grad=True)
    params = dict(mixer.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    try:
        y = ssm.ssm_forward(mixer, xt, pcfg)
        grads = torch.autograd.grad((y * y).sum(), [xt, *params.values()])
    finally:
        for t in params.values():
            t.requires_grad_(False)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), atol=1e-3,
                               rtol=1e-4)
    want_p = bridge._state_from_tree(_np_tree(gp), 0)
    for (name, _), g in zip(params.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want_p[name], atol=1e-3,
                                   rtol=1e-4, err_msg=name)
    tokens = np.random.default_rng(3).integers(
        4, cfg.vocab_size, (2, 19)).astype(np.int32)
    assert check_forward_and_grads(tier, tokens) == 0.0


# --------------------------------------------------------- dense path
def test_dense_path_matches_reference(jamba):
    """Prefill of PAD-padded rows into slabs sized past the prompt, then
    two decode steps: logits, both K/V slabs and both state slabs after
    each call."""
    m, p, bundle, model = jamba
    rng = np.random.default_rng(2)
    toks = rng.integers(4, HYBRID.vocab_size, (3, 11)).astype(np.int32)
    toks[1, 6:] = 0
    jl, jc = jax.jit(lambda t: m.prefill(p, {"tokens": t}, 14))(
        jnp.asarray(toks))
    tl, tc = bundle.prefill(model, {"tokens": torch.tensor(toks)}, 14)
    step = jax.jit(lambda c, t: m.decode_step(p, c, t))
    for i in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"call {i}")
        for k in ("k", "v", "ssm_h", "ssm_conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL, err_msg=f"call {i}: {k}")
        assert tc["pos"] == int(jc["pos"])
        tok = rng.integers(4, HYBRID.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = step(jc, jnp.asarray(tok))
        tl, tc = bundle.decode_step(model, tc, torch.tensor(tok))


# --------------------------------------------------------- paged path
def test_paged_path_matches_reference(jamba):
    """Three prefill chunks over the page pool and the recurrent-state
    rows (ragged rows, an n_new = 0 padding row on the scratch row, a
    chunk mid-prompt, and a slot reused from position 0 over stale
    state), then two decode steps (the second with an idle slot, whose
    row must keep its state): logits, the pools (all but the scratch
    page) and every state row but the scratch row, after every call."""
    m, p, bundle, model = jamba
    cfg = m.cfg
    ps, n_slots, C = 4, 3, 8
    pt = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [0] * 5], np.int32)
    pt_reuse = np.array([[11, 12, 13, 14, 15], [6, 7, 8, 9, 10], [0] * 5],
                        np.int32)
    rng = np.random.default_rng(1)
    jcache = {**m.init_paged_cache(16, ps),
              "rec": m.init_recurrent_state(n_slots + 1)}
    tcache = {**bundle.init_paged_cache(16, ps, device="cpu"),
              "rec": bundle.init_recurrent_state(n_slots + 1, device="cpu")}
    prefill = jax.jit(lambda c, t, pt, s, n, r: m.prefill_paged_chunk(
        p, c, t, pt, s, n, state_rows=r))
    decode = jax.jit(lambda c, t, pt, sl, a: m.decode_step_paged(
        p, c, t, pt, sl, a))
    T = torch.tensor

    def check(jl, tl, what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=what)
        for k in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tcache[k][:, 1:].numpy(),
                                       np.asarray(jcache[k])[:, 1:],
                                       atol=ATOL, err_msg=f"{what}: {k}")
        for k in ("h", "conv"):
            np.testing.assert_allclose(
                tcache["rec"][k][1:].numpy(),
                np.asarray(jcache["rec"][k])[1:], atol=ATOL,
                err_msg=f"{what}: {k}")

    # (page table, state rows, start, n_new): slots 0 and 1 stream their
    # prompts, then slot 0 takes a fresh prompt at position 0 in its row
    for table, rows, start, n_new in (
            (pt, [1, 2, 0], [0, 0, 0], [8, 5, 0]),
            (pt, [1, 2, 0], [8, 5, 0], [4, 7, 0]),
            (pt_reuse, [1, 2, 0], [0, 12, 0], [6, 3, 0])):
        args = [np.asarray(a, np.int32) for a in (start, n_new, rows)]
        toks = rng.integers(4, cfg.vocab_size, (3, C)).astype(np.int32)
        x, jcache = prefill(jcache, jnp.asarray(toks), jnp.asarray(table),
                            *map(jnp.asarray, args))
        tx = bundle.prefill_paged_chunk(model, tcache, T(toks), T(table),
                                        *map(T, args[:2]),
                                        state_rows=T(args[2]))
        check(m.lm_head(p, x), bundle.lm_head(model, tx),
              f"prefill chunk rows {rows} at {start}")
    lens = np.array([6, 15, 0], np.int32)
    for active in (np.array([True, True, False]),
                   np.array([False, True, False])):
        toks = rng.integers(4, cfg.vocab_size, (n_slots, 1)).astype(np.int32)
        jl, jcache = decode(jcache, jnp.asarray(toks), jnp.asarray(pt_reuse),
                            jnp.asarray(lens), jnp.asarray(active))
        tl = bundle.decode_step_paged(model, tcache, T(toks), T(pt_reuse),
                                      T(lens), T(active))
        check(jl, tl, f"decode, active {active}")
        lens = lens + active


def test_refuses_one_shot_and_prefix_sharing(jamba):
    """As the reference's engine: one-shot admission raises for a
    recurrent-state stack, and a prefix cache is refused with the
    reference's ``prefix_reason`` (the tier serves unshared); no verify
    chunk."""
    m, p, bundle, model = jamba
    with pytest.raises(ValueError, match="chunked prefill"):
        ContinuousEngine(bundle, model, prefill_chunk=0)
    with pytest.raises(ValueError):
        JaxEngine(m, p, prefill_chunk=0)
    eng = ContinuousEngine(bundle, model, max_seq=32, prefix_cache=8)
    ref = JaxEngine(m, p, max_seq=32, prefix_cache=8)
    assert eng.prefix_reason == ref.prefix_reason
    assert eng.prefix_reason.startswith("recurrent state")
    assert eng.prefix_cache == ref.prefix_cache == 0
    assert bundle.verify_paged_chunk is None and m.verify_paged_chunk is None


# -------------------------------------------------------------- configs
def test_published_configs_convert_one_to_one():
    """tests/test_arch_smoke.py::test_arch_config_exactness for the three
    copies: each equals the reference's field for field, with the
    published dimensions and the same parameter counts; each builds, and
    grok-1 at tiny widths serves a prefill and a decode step."""
    dims = {"grok-1-314b": (64, 6144, 48, 8, 32768, 131072),
            "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
            "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064)}
    for port, ref in ((GROK, JAX_GROK), (JAMBA, JAX_JAMBA), (PHI, JAX_PHI)):
        assert ArchConfig(**dataclasses.asdict(ref)) == port
        assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
                port.d_ff, port.vocab_size) == dims[port.name]
        assert port.param_count() == ref.param_count()
        assert build_model(port).cfg is port
    assert (GROK.n_experts, PHI.n_experts, JAMBA.n_experts) == (8, 16, 16)
    small = dataclasses.replace(GROK, n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, head_dim=16, d_ff=128,
                                vocab_size=256, vocab_pad_multiple=64)
    bundle = build_model(small)
    model = bundle.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(4, 256, (2, 9), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        logits, cache = bundle.prefill(model, {"tokens": toks}, 10)
        nxt, _ = bundle.decode_step(model, cache, logits.argmax(-1)[:, None])
    assert torch.isfinite(nxt[:, :256]).all()

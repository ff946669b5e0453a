"""The port's data, config and model modules against the JAX package, on
weights carried across by the bridge (repro_torch.bridge): the same numpy
inputs through both, fp32 at "highest" matmul precision on both sides."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.experiment import TIERS
from repro.data import tasks as jax_tasks, tokenizer as jax_tok
from repro.configs.qwen15_32b import CONFIG as JAX_QWEN
from repro.models import common as jax_common, decoder as jax_decoder
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.models import router_encode as jax_router_encode
from repro.models.config import ArchConfig as JaxArchConfig
from repro.training.checkpoint import save_checkpoint
from repro_torch import bridge
from repro_torch.configs.qwen15_32b import CONFIG as QWEN
from repro_torch.data import tasks, tokenizer as tok
from repro_torch.models import common, decoder
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig, router_encode
from repro_torch.models.frontends import make_batch
from repro_torch.models.model import build_model
from conftest import tiny_cfg

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4    # logits / hidden states: fp32, another summation order


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


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- copies
def test_data_copies_give_identical_arrays():
    for name in ("PAD", "BOS", "EOS", "SEP", "CHAR_BASE", "VOCAB_SIZE"):
        assert getattr(tok, name) == getattr(jax_tok, name)
    a = tasks.generate_dataset(np.random.default_rng(5), 64, 16, 12)
    b = jax_tasks.generate_dataset(np.random.default_rng(5), 64, 16, 12)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    la, lb = tasks.lm_training_arrays(a), jax_tasks.lm_training_arrays(b)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k])
    assert tok.decode(a.query[0]) == jax_tok.decode(b.query[0])


@pytest.mark.parametrize("cfg", [tiny_cfg("dense"), tiny_cfg("hybrid"),
                                 TIERS["large"][0], JAX_QWEN],
                         ids=["tiny", "hybrid", "tiers_large", "qwen"])
def test_arch_config_converts_one_to_one(cfg):
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxArchConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(ArchConfig)] \
        == ref
    port = _port_cfg(cfg)
    for prop in ("resolved_head_dim", "padded_vocab", "supports_paged_kv",
                 "has_window_layers", "param_count"):
        got, want = getattr(port, prop), getattr(cfg, prop)
        if callable(got):
            got, want = got(), want()
        assert got == want, prop
    assert _port_cfg(JAX_QWEN) == QWEN


# ---------------------------------------------------------------- layers
def test_common_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        common.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4).numpy(),
        np.asarray(jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e4)), atol=1e-5)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    norm = common.RMSNorm(32, torch.float32)
    norm.scale.data = torch.tensor(scale)
    np.testing.assert_allclose(
        common.rmsnorm(norm, torch.tensor(h), 1e-6).numpy(),
        np.asarray(jax_common.rmsnorm({"scale": jnp.asarray(scale)},
                                      jnp.asarray(h), 1e-6)), atol=1e-6)
    table = rng.standard_normal((64, 32)).astype(np.float32)
    emb = common.Embedding(64, 32, torch.float32)
    emb.table.data = torch.tensor(table)
    got = common.unembed(emb, torch.tensor(h), 50).numpy()
    want = np.asarray(jax_common.unembed({"table": jnp.asarray(table)},
                                         jnp.asarray(h), 50))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[:, 50:] == np.finfo(np.float32).min).all()


def test_init_follows_reference_distributions():
    cfg = _port_cfg(tiny_cfg("dense", qkv_bias=True, d_model=128, d_ff=256))
    m = decoder.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = m.layers[0]
    assert (layer.ln1.scale == 1).all() and (layer.attn.bq == 0).all()
    for w, fan_in in ((m.embed.table, None), (layer.attn.wq, 128),
                      (layer.mlp.w_out, 256), (m.head.w, 128)):
        std = 0.02 if fan_in is None else fan_in ** -0.5
        assert w.abs().max() <= 2 * std + 1e-7
        # N(0, 1) truncated to +-2 has standard deviation 0.8796
        assert abs(w.std().item() / (0.8796 * std) - 1) < 0.05


# --------------------------------------------------------------- decoder
def _decoder_pair(cfg, seed=0):
    """Reference bundle + params, and the port's decoder on bridged
    weights."""
    m = jax_build_model(cfg)
    p = jax.jit(m.init)(jax.random.PRNGKey(seed))
    return m, p, bridge.params_from_numpy(_np_tree(p), _port_cfg(cfg),
                                          "cpu")


@pytest.mark.parametrize("cfg", [
    tiny_cfg("dense"),                              # GQA, G = 2
    tiny_cfg("dense", qkv_bias=True, n_kv_heads=4),  # MHA with QKV bias
    TIERS["large"][0],                              # head_dim 24, tied
], ids=["gqa", "qkv_bias", "tiers_large"])
def test_paged_decoder_matches_reference(cfg):
    """Two prefill chunks (the second mid-context, ragged) then two decode
    steps (the second with an idle slot): logits and both page pools
    element by element after every call (all but the scratch page)."""
    m, p, port = _decoder_pair(cfg)
    pcfg = _port_cfg(cfg)
    ps, P, C = 8, 8, 8
    pt = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    rng = np.random.default_rng(1)
    jcache = jax_decoder.init_paged_decode_cache(cfg, P, ps)
    tcache = decoder.init_paged_decode_cache(pcfg, P, ps, "cpu")
    prefill = jax.jit(lambda c, t, s, n: jax_decoder.decoder_prefill_paged_chunk(
        p, c, t, jnp.asarray(pt), s, n, cfg, pages_bound=2))
    decode = jax.jit(lambda c, t, sl, a: jax_decoder.decoder_decode_step_paged(
        p, c, t, jnp.asarray(pt), sl, a, cfg, pages_bound=4))
    T = torch.tensor

    def check(jl, tl, what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=what)
        # every page but the scratch page 0, where padding rows and idle
        # slots write duplicates in an order neither framework fixes
        for k in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tcache[k][:, 1:].numpy(),
                                       np.asarray(jcache[k])[:, 1:],
                                       atol=ATOL, err_msg=f"{what}: {k}")

    start = np.zeros(2, np.int32)
    for n_new in (np.array([8, 5], np.int32), np.array([4, 7], np.int32)):
        toks = rng.integers(4, cfg.vocab_size, (2, C)).astype(np.int32)
        x, jcache = prefill(jcache, jnp.asarray(toks), jnp.asarray(start),
                            jnp.asarray(n_new))
        tx = decoder.decoder_prefill_paged_chunk(
            port, tcache, T(toks), T(pt), T(start), T(n_new), pcfg,
            pages_bound=2)
        check(m.lm_head(p, x), decoder._unembed(port, tx, pcfg),
              f"prefill chunk at {start}")
        start = start + n_new
    lens = start.copy()
    for active in (np.array([True, True]), np.array([True, False])):
        toks = rng.integers(4, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = decode(jcache, jnp.asarray(toks), jnp.asarray(lens),
                            jnp.asarray(active))
        tl = decoder.decoder_decode_step_paged(
            port, tcache, T(toks), T(pt), T(lens), T(active), pcfg,
            pages_bound=4)
        check(jl, tl, f"decode at {lens}")
        lens = lens + active


# ---------------------------------------------------------------- router
def test_router_encode_matches_reference():
    # sequences longer than rel_max_distance exercise the log buckets
    rcfg = JaxRouterConfig(vocab_size=64, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64, rel_max_distance=16)
    p = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(3), rcfg)
    port = bridge.params_from_numpy(_np_tree(p), RouterConfig(
        **dataclasses.asdict(rcfg)), "cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 64, (3, 40)).astype(np.int32)
    mask = (np.arange(40)[None] < np.array([[40], [17], [1]])
            ).astype(np.float32)
    want = np.asarray(jax.jit(jax_router_encode, static_argnums=3)(
        p, jnp.asarray(tokens), jnp.asarray(mask), rcfg))
    got = router_encode(port, torch.tensor(tokens), torch.tensor(mask),
                        RouterConfig(**dataclasses.asdict(rcfg))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------- bridge
def test_bridge_loads_a_reference_checkpoint(tmp_path):
    cfg = tiny_cfg("dense", qkv_bias=True)
    _, p, _ = _decoder_pair(cfg, seed=4)
    path = str(tmp_path / "lm.npz")
    save_checkpoint(path, p)
    port = bridge.params_from_numpy(bridge.load_checkpoint(path),
                                    _port_cfg(cfg), "cpu")
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(p)[0]}
    for name, t in port.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            want = flat["/".join(["layers"] + parts[2:])][int(parts[1])]
        else:
            want = flat["/".join(parts)]
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)


def test_bridge_rejects_a_tree_that_does_not_fit():
    cfg = tiny_cfg("dense")
    tree = _np_tree(_decoder_pair(cfg)[1])
    with pytest.raises(ValueError, match="unexpected"):
        bridge.params_from_numpy(tree, _port_cfg(dataclasses.replace(
            cfg, tie_embeddings=True)), "cpu")
    tree["ln_f"]["scale"] = tree["ln_f"]["scale"][:-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(tree, _port_cfg(cfg), "cpu")


@pytest.mark.parametrize("family", ["moe", "window", "hybrid", "vlm",
                                    "audio"])
def test_build_model_names_the_slice_for_other_families(family):
    """Every family builds since the encoder-decoder and frontends slice
    landed: a MoE stack, a sliding-window stack with MoE layers (no
    verify chunk, as the reference's bundle), a hybrid stack (with
    recurrent-state rows), and the vlm and audio (encoder-decoder)
    stacks, which have no paged path, as the reference's bundles, and
    prefill on their frontend's inputs."""
    cfg = tiny_cfg(family)
    if family == "window":
        cfg = tiny_cfg("dense", n_experts=4, top_k=2, sliding_window=4,
                       local_global_ratio=1)
    bundle = build_model(_port_cfg(cfg))
    ref = jax_build_model(cfg)
    for field in ("verify_paged_chunk", "init_recurrent_state",
                  "decode_step_paged", "init_paged_cache",
                  "prefill_paged_chunk", "lm_head"):
        assert (getattr(bundle, field) is None) == \
            (getattr(ref, field) is None), field
    model = bundle.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(torch.Generator().manual_seed(1), bundle.cfg, 1, 5,
                       for_train=False, device="cpu")
    with torch.no_grad():
        logits, _ = bundle.prefill(model, batch)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()


# ------------------------------------------------------------- isolation
def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = "
            "None; sys.modules['ml_dtypes'] = None\n"
            "import importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n    importlib.import_module(m.name)\n"
            "print('imported')")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)")
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            assert not bad.match(line), f"{f}:{i}: {line}"

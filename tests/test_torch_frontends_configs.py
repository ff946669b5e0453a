"""The port's vision-frontend (vlm) family, the frontend terms of the
dense serving path and the config registry, against the JAX package:
the vlm ``forward``, ``prefill`` and ``decode_step`` on bridged weights,
``build_generate_fn`` with 8 frontend tokens (its cache sized with them),
``Engine._kv_slab_bytes``, ``make_engine``'s fallback to ``Engine`` and the
token-only engines' refusal, and mirrors of tests/test_arch_smoke.py and
tests/test_config_serving_matrix.py over ``ARCH_IDS`` (the port's
reduced configs, held field by field to the reference's ``reduced()``).
Inputs are made with numpy from a seed; fp32 at "highest" matmul
precision on both sides; logits within TOL of their scale, greedy tokens
exact."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_pair as jax_get_pair
from repro.data import tokenizer as jax_tok
from repro.models import build_model as jax_build_model
from repro.serving import Engine as JaxEngine
from repro.serving.engine import make_engine as jax_make_engine
from repro.serving.generate import build_generate_fn as jax_generate_fn
from repro_torch.configs import ARCH_IDS, ARCHS, get_config, get_pair
from repro_torch.data import tokenizer as tok
from repro_torch.models.common import softmax_xent
from repro_torch.models.config import ArchConfig
from repro_torch.models.frontends import make_batch
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine, Engine, make_engine
from repro_torch.serving.generate import build_generate_fn, sample_responses
from repro_torch.training.optim import AdamWConfig, init_opt_state
from repro_torch.training.trainer import make_lm_train_step, trainable
from conftest import tiny_cfg
from test_torch_encdec import TOL, _jax, _torch, assert_scaled
from test_torch_serving import _tier, highest_precision  # noqa: F401

VLM = tiny_cfg("vlm")      # 8 frontend tokens


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def vlm():
    return _tier(VLM, 0)


def _vlm_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32),
            "frontend_embeds": (rng.standard_normal(
                (B, cfg.num_frontend_tokens, cfg.d_model)) * 0.02)
            .astype(np.float32)}


# ----------------------------------------------------------------- vlm
def test_vlm_forward_prefill_decode_match_reference(vlm):
    """The teacher-forced logits over the token positions (the frontend's
    dropped before the head), the prefill's last logits and cache over
    n_front + S positions, and three decode steps from position
    n_front + S, against the reference's; decode equals teacher
    forcing."""
    m, p, bundle, model = vlm
    cfg, V = m.cfg, m.cfg.vocab_size
    n_front = cfg.num_frontend_tokens
    b = _vlm_inputs(cfg, 2, 9, 1)
    want, _ = jax.jit(m.forward)(p, _jax(b))
    with torch.no_grad():
        got, aux = bundle.forward(model, _torch(b))
    assert got.shape == (2, 9, cfg.padded_vocab)
    assert_scaled(got[..., :V].numpy(), np.asarray(want)[..., :V],
                  what="forward")
    prompt = {**b, "tokens": b["tokens"][:, :6]}
    max_seq = n_front + 9
    jlast, jc = jax.jit(m.prefill, static_argnums=2)(p, _jax(prompt),
                                                      max_seq)
    with torch.no_grad():
        last, cache = bundle.prefill(model, _torch(prompt), max_seq)
    assert cache["pos"] == int(jc["pos"]) == n_front + 6
    for k in ("k", "v"):
        assert cache[k].shape[2] == max_seq
        assert_scaled(cache[k].numpy(), jc[k], what=k)
    assert_scaled(last[:, :V].numpy(), np.asarray(jlast)[:, :V],
                  what="prefill")
    step = jax.jit(m.decode_step)
    for t in range(6, 9):
        token = b["tokens"][:, t:t + 1]
        jlast, jc = step(p, jc, jnp.asarray(token))
        with torch.no_grad():
            last, cache = bundle.decode_step(model, cache,
                                             torch.tensor(token))
        assert_scaled(last[:, :V].numpy(), np.asarray(jlast)[:, :V],
                      what=f"decode {t}")
        assert_scaled(last[:, :V].numpy(), got[:, t, :V].numpy(),
                      what=f"decode {t} vs teacher")


def test_vlm_generate_sizes_its_cache_with_the_frontend(vlm):
    """``build_generate_fn`` at temperature 0 on 8 frontend tokens and a
    7-token prompt: the reference's greedy tokens and lengths, and a cache
    of 8 + 7 + 6 positions (decode runs to the last of them)."""
    m, p, bundle, model = vlm
    b = _vlm_inputs(m.cfg, 3, 7, 2)
    want, want_len = jax_generate_fn(m, 6, 0.0)(p, _jax(b),
                                                jax.random.PRNGKey(0))
    sizes = []
    prefill = bundle.prefill

    def recorded(model, batch, max_seq=None):
        sizes.append(max_seq)
        return prefill(model, batch, max_seq)

    gen = build_generate_fn(dataclasses.replace(bundle, prefill=recorded),
                            6, 0.0)
    got, got_len = gen(model, _torch(b), torch.Generator().manual_seed(0))
    assert sizes == [8 + 7 + 6]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("family", ["vlm", "audio", "dense"])
def test_kv_slab_bytes_matches_reference(family):
    """The dense engine's reported KV slab, the vlm frontend's positions
    included (the encoder-decoder's cross slabs are not counted, as in the
    reference)."""
    cfg = tiny_cfg(family)
    m, bundle = jax_build_model(cfg), build_model(_port_cfg(cfg))
    model = bundle.init(torch.Generator().manual_seed(0), "cpu")
    want = JaxEngine(m, None, max_new_tokens=5)._kv_slab_bytes(4, 7)
    assert Engine(bundle, model, max_new_tokens=5)._kv_slab_bytes(4, 7) \
        == want
    if family == "vlm":
        assert want == 2 * 4 * (7 + 8 + 5) * 2 * 16 * 2 * 4


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_make_engine_falls_back_and_token_only_engines_refuse(family):
    """A paged-layout vlm or audio config has no paged path: make_engine
    returns the dense ``Engine`` (as the reference's does), the continuous
    engine refuses it naming the config's reason, and the token-only
    ``Engine.serve``, ``warmup`` and ``sample_responses`` raise and name
    ``build_generate_fn``, where the reference fails with a KeyError."""
    cfg = tiny_cfg(family, cache_layout="paged")
    pcfg = _port_cfg(cfg)
    bundle = build_model(pcfg)
    model = bundle.init(torch.Generator().manual_seed(0), "cpu")
    assert bundle.decode_step_paged is None
    eng = make_engine(bundle, model, max_new_tokens=4, n_slots=2)
    assert type(eng) is Engine
    assert type(jax_make_engine(jax_build_model(cfg), None,
                                max_new_tokens=4)) is JaxEngine
    with pytest.raises(ValueError, match=pcfg.paged_unsupported_reason[:12]):
        ContinuousEngine(bundle, model, max_new_tokens=4, n_slots=2)
    q = np.full((2, 5), 7, np.int32)
    for call in (lambda: eng.serve(q), lambda: eng.warmup(5, 2),
                 lambda: sample_responses(bundle, model, q, 1, 4)):
        with pytest.raises(ValueError, match="build_generate_fn"):
            call()
    m = jax_build_model(cfg)
    p = jax.jit(m.init)(jax.random.PRNGKey(0))
    with pytest.raises(KeyError):
        JaxEngine(m, p, max_new_tokens=4).serve(q)
    dense = tiny_cfg("dense", cache_layout="paged")
    db = build_model(_port_cfg(dense))
    assert type(make_engine(db, db.init(torch.Generator().manual_seed(0),
                                        "cpu"), max_new_tokens=4,
                            n_slots=2, max_seq=32)) is ContinuousEngine


# ------------------------------------------------------------ registry
EXPECTED = {   # tests/test_arch_smoke.py::test_arch_config_exactness
    "grok-1-314b": (64, 6144, 48, 8, 32768, 131072),
    "mistral-large-123b": (88, 12288, 96, 8, 28672, 32768),
    "gemma3-4b": (34, 2560, 8, 4, 10240, 262144),
    "internvl2-26b": (48, 6144, 48, 8, 16384, 92553),
    "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
    "qwen1.5-32b": (64, 5120, 40, 40, 27392, 152064),
    "whisper-large-v3": (32, 1280, 20, 20, 5120, 51866),
    "mamba2-130m": (24, 768, 0, 0, 0, 50280),
    "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
    "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
}


def test_registry_ids_and_lookup():
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    assert set(EXPECTED) == set(ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_config_exactness(arch):
    """Each config equals the reference's field by field, carries the
    published dimensions, builds (paged fields None exactly where the
    reference's are, with its reason) and pairs with the reference's
    small sibling."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg is ARCHS[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == EXPECTED[arch]
    assert cfg.paged_unsupported_reason == ref.paged_unsupported_reason
    assert cfg.param_count() == ref.param_count()
    for scale in (2, 4):
        small, large = get_pair(arch, scale)
        jsmall, jlarge = jax_get_pair(arch, scale)
        assert large is cfg
        assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    bundle, jbundle = build_model(cfg), jax_build_model(ref)
    for field in ("decode_step_paged", "prefill_paged_chunk",
                  "init_paged_cache", "lm_head", "verify_paged_chunk",
                  "init_recurrent_state"):
        assert (getattr(bundle, field) is None) == \
            (getattr(jbundle, field) is None), (arch, field)


def _reduced(arch, **kw):
    """The port's reduced smoke variant, held field by field to the
    reference's."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(jax_get_config(arch).reduced(), **kw))
    return cfg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke(arch):
    """tests/test_arch_smoke.py::test_arch_smoke on the port: the reduced
    variant runs one forward (shapes, finite logits), one AdamW train step
    (finite loss and grad norm, parameters changed), and a prefill plus a
    decode step on the CPU."""
    cfg = _reduced(arch)
    assert cfg.d_model <= 512 and (cfg.n_experts or 0) <= 4
    m = build_model(cfg)
    model = m.init(torch.Generator().manual_seed(0), "cpu")
    seq = 16
    batch = make_batch(torch.Generator().manual_seed(1), cfg, 2, seq,
                       device="cpu")
    with torch.no_grad():
        logits, aux = m.forward(model, batch)
    assert logits.shape == (2, seq, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all(), arch

    ocfg = AdamWConfig(lr=1e-3, total_steps=10)
    before = {k: p.clone() for k, p in model.named_parameters()}
    opt = init_opt_state(dict(model.named_parameters()), ocfg)
    step = make_lm_train_step(m, ocfg, aux_weight=0.01)
    with trainable(model):
        _, opt, met = step(model, opt, batch)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    delta = sum(float((p - before[k]).abs().sum())
                for k, p in model.named_parameters())
    assert delta > 0, arch
    with torch.no_grad():
        loss = softmax_xent(m.forward(model, batch)[0], batch["labels"],
                            batch["loss_mask"])
    assert torch.isfinite(loss)

    inf = {k: v for k, v in batch.items() if k not in ("labels",
                                                        "loss_mask")}
    # the cache holds the vlm frontend's positions too (the reference's
    # test passes seq + 4, and its decode writes at a clamped position)
    n_front = cfg.frontend_positions
    with torch.no_grad():
        last, cache = m.prefill(model, inf, n_front + seq + 4)
        token = last.argmax(-1)[:, None]
        lg, cache2 = m.decode_step(model, cache, token)
    assert lg.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(lg[..., :cfg.vocab_size]).all(), arch
    assert cache2["pos"] == n_front + seq + 1


# tests/test_config_serving_matrix.py::UNSUPPORTED
UNSUPPORTED = {"whisper-large-v3": "encoder-decoder",
               "internvl2-26b": "frontend"}


@pytest.mark.parametrize("name", ARCH_IDS)
def test_every_config_serves_or_declares_unsupported(name):
    """tests/test_config_serving_matrix.py on the port: each reduced
    config with the tiny vocabulary and the paged layout either serves
    two prompts through ``ContinuousEngine`` (admit, chunked prefill, 4
    decode steps, retire; a recurrent-state pool exactly for the SSM and
    hybrid stacks) or declares the reference's unsupported reason and has
    no paged path."""
    kw = dict(vocab_size=tok.VOCAB_SIZE, vocab_pad_multiple=16,
              cache_layout="paged")
    cfg = _reduced(name, **kw)
    ref = dataclasses.replace(jax_get_config(name).reduced(), **kw)
    assert tok.VOCAB_SIZE == jax_tok.VOCAB_SIZE
    assert cfg.paged_unsupported_reason == ref.paged_unsupported_reason
    declared = {n for n in ARCH_IDS
                if _reduced(n, **kw).paged_unsupported_reason is not None}
    assert declared == set(UNSUPPORTED)
    bundle = build_model(cfg)
    if name in UNSUPPORTED:
        assert UNSUPPORTED[name].split("-")[0] in cfg.paged_unsupported_reason
        assert bundle.decode_step_paged is None
        return
    assert bundle.decode_step_paged is not None, name
    model = bundle.init(torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousEngine(bundle, model, max_new_tokens=4, n_slots=2,
                           max_seq=32)
    q = np.random.default_rng(1).integers(4, tok.VOCAB_SIZE, (2, 7)) \
        .astype(np.int32)
    out, lens = eng.serve(q)
    assert out.shape == (2, 4) and (lens >= 1).all(), (name, lens)
    assert eng.stats.retired == 2
    assert (eng.rstate is not None) == ref.has_recurrent_layers, name

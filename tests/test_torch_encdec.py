"""The port's encoder-decoder family (whisper) against the JAX package on
bridged weights: ``encode``, the teacher-forced ``forward`` and its
gradients, ``prefill`` plus decode steps (equal to the reference's and to
teacher forcing), ``decode_cross_attention``, ``attention_forward`` with
``kv_override``, ``use_rope=False`` and ``causal=False``,
``build_generate_fn`` on the reference's ``make_batch`` inputs, and the
bridge's ``enc_layers``/``dec_layers`` trees. Inputs are made with numpy
from a seed; fp32 at "highest" matmul precision on both sides. Values are
held within TOL of their scale (the largest magnitude of the reference's
output), greedy tokens exactly."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.models.common import softmax_xent as jax_softmax_xent
from repro.models.frontends import make_batch as jax_make_batch
from repro.serving.generate import build_generate_fn as jax_generate_fn
from repro_torch import bridge
from repro_torch.models import attention, encdec
from repro_torch.models.common import softmax_xent
from repro_torch.serving.generate import build_generate_fn
from repro_torch.training.trainer import trainable
from conftest import tiny_cfg
from test_torch_serving import (_np_tree, _tier,  # noqa: F401
                                highest_precision)

TOL = 1e-5        # max abs error over the reference's largest magnitude
GRAD_TOL = 1e-4   # gradients: the same, through the backward pass

AUDIO = tiny_cfg("audio")                  # MHA, enc_seq 16
AUDIO_GQA = tiny_cfg("audio", name="audio-gqa", n_kv_heads=2,
                     tie_embeddings=False)


@pytest.fixture(scope="module")
def whisper():
    return _tier(AUDIO, 0)


@pytest.fixture(scope="module")
def whisper_gqa():
    return _tier(AUDIO_GQA, 1)


def assert_scaled(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32),
            "enc_embeds": (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                           * 0.02).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("tier", ["whisper", "whisper_gqa"])
def test_encode_matches_reference(tier, request):
    m, p, bundle, model = request.getfixturevalue(tier)
    b = _inputs(m.cfg, 3, 5, 2)
    want = jax.jit(lambda p, e: jax_encdec.encode(p, e, m.cfg))(
        p, jnp.asarray(b["enc_embeds"]))
    with torch.no_grad():
        got = encdec.encode(model, torch.tensor(b["enc_embeds"]), bundle.cfg)
    assert_scaled(got.numpy(), want, what="encode")


@pytest.mark.parametrize("tier", ["whisper", "whisper_gqa"])
def test_forward_matches_reference(tier, request):
    m, p, bundle, model = request.getfixturevalue(tier)
    b = _inputs(m.cfg, 2, 11, 3)
    want, waux = jax.jit(m.forward)(p, _jax(b))
    with torch.no_grad():
        got, aux = bundle.forward(model, _torch(b))
    V = m.cfg.vocab_size
    assert_scaled(got[..., :V].numpy(), np.asarray(want)[..., :V],
                  what="logits")
    assert float(aux) == float(waux) == 0.0


def test_forward_gradients_match_reference(whisper_gqa):
    """The gradient of the token cross-entropy with respect to every
    parameter (encoder, both attentions, the untied head) against
    ``jax.grad`` on the same batch."""
    m, p, bundle, model = whisper_gqa
    b = _inputs(m.cfg, 2, 9, 4)
    labels = np.roll(b["tokens"], -1, axis=1)

    def jloss(p):
        logits, _ = m.forward(p, _jax(b))
        return jax_softmax_xent(logits, jnp.asarray(labels))

    jtot, jgrads = jax.jit(jax.value_and_grad(jloss))(p)
    params = dict(model.named_parameters())
    with trainable(model):
        logits, _ = bundle.forward(model, _torch(b))
        tot = softmax_xent(logits, torch.tensor(labels))
        grads = torch.autograd.grad(tot, list(params.values()))
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-6)
    want = bridge._state_from_tree(_np_tree(jgrads), m.cfg.n_layers)
    assert want.keys() == params.keys()
    assert any(n.startswith("enc_layers.") for n in want)
    for (name, _), g in zip(params.items(), grads):
        assert_scaled(g.numpy(), want[name], GRAD_TOL, name)


# ------------------------------------------------------ prefill, decode
def test_prefill_and_decode_match_reference_and_teacher_forcing(whisper):
    """An 8-token prompt, then 4 decode steps fed the teacher's tokens
    (tests/test_models.py::test_decode_matches_teacher_forcing for
    audio): each step's logits against the reference's and against the
    port's teacher-forced logits at that position; the caches' self and
    cross K/V against the reference's."""
    m, p, bundle, model = whisper
    b = _inputs(m.cfg, 2, 12, 5)
    V = m.cfg.vocab_size
    with torch.no_grad():
        teacher, _ = bundle.forward(model, _torch(b))
    prompt = {**b, "tokens": b["tokens"][:, :8]}
    jlast, jc = jax.jit(m.prefill, static_argnums=2)(p, _jax(prompt), 16)
    with torch.no_grad():
        last, cache = bundle.prefill(model, _torch(prompt), 16)
    assert cache["pos"] == int(jc["pos"]) == 8
    for k in ("k", "v", "cross_k", "cross_v"):
        assert_scaled(cache[k].numpy(), jc[k], what=k)
    assert cache["cross_valid"].dtype == torch.int8
    assert bool((cache["cross_valid"] == 1).all())
    assert_scaled(last[:, :V].numpy(), np.asarray(jlast)[:, :V],
                  what="prefill")
    assert_scaled(last[:, :V].numpy(), teacher[:, 7, :V].numpy(),
                  what="prefill vs teacher")
    step = jax.jit(m.decode_step)
    for t in range(8, 12):
        tok = b["tokens"][:, t:t + 1]
        jlast, jc = step(p, jc, jnp.asarray(tok))
        with torch.no_grad():
            last, cache = bundle.decode_step(model, cache, torch.tensor(tok))
        assert_scaled(last[:, :V].numpy(), np.asarray(jlast)[:, :V],
                      what=f"decode {t}")
        assert_scaled(last[:, :V].numpy(), teacher[:, t, :V].numpy(),
                      what=f"decode {t} vs teacher")
    assert cache["pos"] == 12
    for k in ("k", "v"):
        assert_scaled(cache[k].numpy(), jc[k], what=k)


def test_windowed_decode_matches_reference(whisper):
    """``windowed=True`` reaches the decoder's self-attention: a window of
    4 after a 3-position sink over a 14-position cache."""
    import dataclasses
    cfg = dataclasses.replace(AUDIO, long_context_window=4,
                              attention_sink=3)
    m, p, _, model = whisper
    from repro.models import build_model as jax_build_model
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model import build_model
    jm = jax_build_model(cfg)
    bundle = build_model(ArchConfig(**dataclasses.asdict(cfg)))
    b = _inputs(cfg, 2, 10, 6)
    prompt = {**b, "tokens": b["tokens"][:, :6]}
    _, jc = jax.jit(jm.prefill, static_argnums=2)(p, _jax(prompt), 14)
    with torch.no_grad():
        _, cache = bundle.prefill(model, _torch(prompt), 14)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, windowed=True))
    for t in range(6, 10):
        tok = b["tokens"][:, t:t + 1]
        jl, jc = step(p, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, cache = bundle.decode_step(model, cache, torch.tensor(tok),
                                           windowed=True)
        assert_scaled(tl[:, :cfg.vocab_size].numpy(),
                      np.asarray(jl)[:, :cfg.vocab_size],
                      what=f"windowed decode {t}")


# ----------------------------------------------------------- attention
@pytest.mark.parametrize("tier", ["whisper", "whisper_gqa"])
def test_decode_cross_attention_matches_reference(tier, request):
    """One query a row over a (B, enc_seq, K, Dh) cross slab: the port's
    entry (the dense decode kernel's plain version here) against the
    reference's unmasked softmax, with the all-valid vector given and
    built."""
    m, p, bundle, model = request.getfixturevalue(tier)
    cfg = m.cfg
    rng = np.random.default_rng(7)
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ek = rng.standard_normal((3, cfg.enc_seq, K, Dh)).astype(np.float32)
    ev = rng.standard_normal((3, cfg.enc_seq, K, Dh)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[1], p["dec_layers"]["cross"])
    want = jax_attn.decode_cross_attention(lp, jnp.asarray(x),
                                           jnp.asarray(ek), jnp.asarray(ev),
                                           cfg)
    layer = model.dec_layers[1].cross
    args = (torch.tensor(x), torch.tensor(ek), torch.tensor(ev), bundle.cfg)
    valid = torch.ones((3, cfg.enc_seq), dtype=torch.int8)
    with torch.no_grad():
        for got in (attention.decode_cross_attention(layer, *args),
                    attention.decode_cross_attention(layer, *args, valid)):
            assert_scaled(got.numpy(), want, what="decode cross")


# name -> (attention_forward keyword arguments, key count or None)
ATTN_OPTIONS = {
    "cross": (dict(causal=False, use_rope=False), 13),
    "cross_roped_q": (dict(causal=False), 13),
    "cross_causal": (dict(causal=True, use_rope=False), 13),
    "no_rope": (dict(use_rope=False), None),
    "non_causal": (dict(causal=False), None),
    "encoder": (dict(causal=False, use_rope=False), None),
}


@pytest.fixture(scope="module")
def biased():
    """A GQA dense layer's reference params with random QKV biases (the
    reference initialises them to zero), and the port's layer holding
    them."""
    cfg = tiny_cfg("dense", qkv_bias=True)
    m, p, bundle, model = _tier(cfg, 3)
    rng = np.random.default_rng(9)
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a[0]).copy(),
                                p["layers"]["attn"])
    layer = model.layers[0].attn
    with torch.no_grad():
        for b in ("bq", "bk", "bv"):
            lp[b] = (rng.standard_normal(lp[b].shape) * 0.3).astype(
                np.float32)
            getattr(layer, b).copy_(torch.tensor(lp[b]))
    return cfg, lp, bundle.cfg, layer


@pytest.mark.parametrize("option", sorted(ATTN_OPTIONS))
def test_attention_forward_options_match_reference(option, biased):
    """``attention_forward`` (serving: the flash kernel's plain version
    for self-attention, the masked softmax for cross-attention) and
    ``training_attention`` (under autograd) against the reference's
    ``attention_forward`` with each option, on a GQA layer with random
    QKV biases and 7 queries; cross-attention over 13 keys."""
    cfg, lp, pcfg, layer = biased
    rng = np.random.default_rng(8)
    kw, n_keys = ATTN_OPTIONS[option]
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    kv = None
    if n_keys:
        K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        kv = [rng.standard_normal((2, n_keys, K, Dh)).astype(np.float32)
              for _ in range(2)]
    want = jax.jit(lambda lp, x, kv: jax_attn.attention_forward(
        lp, x, cfg, kv_override=kv, **kw))(
            lp, jnp.asarray(x), kv and tuple(map(jnp.asarray, kv)))
    tkw = dict(kw, kv_override=kv and tuple(map(torch.tensor, kv)))
    with torch.no_grad():
        got = attention.attention_forward(layer, torch.tensor(x), pcfg,
                                          **tkw)
        train = attention.training_attention(layer, torch.tensor(x), pcfg,
                                             **tkw)
    assert_scaled(got.numpy(), want, what=option)
    assert_scaled(train.numpy(), want, what=f"{option} (training)")


# ------------------------------------------------------------ generate
def test_generate_greedy_tokens_match_reference(whisper_gqa):
    """``build_generate_fn`` at temperature 0 on the reference's
    ``make_batch`` inputs (tokens and stub frame embeddings): the same
    greedy tokens and lengths."""
    m, p, bundle, model = whisper_gqa
    batch = jax_make_batch(jax.random.PRNGKey(4), m.cfg, 3, 7,
                           for_train=False)
    want, want_len = jax_generate_fn(m, 6, 0.0)(p, batch,
                                                jax.random.PRNGKey(0))
    got, got_len = build_generate_fn(bundle, 6, 0.0)(
        model, _torch(batch), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


# -------------------------------------------------------------- bridge
def test_bridge_round_trip_of_enc_and_dec_layers(whisper_gqa):
    """The reference's tree loads (``enc_layers`` split on n_enc_layers,
    ``dec_layers`` on n_layers) and comes back equal; an encoder layer
    count that does not fit, a missing tensor and a mis-shaped tensor
    raise."""
    import dataclasses
    m, p, bundle, model = whisper_gqa
    tree = _np_tree(p)
    back = bridge.numpy_from_params(model, bundle.cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    np.testing.assert_array_equal(model.dec_layers[1].cross.wk.numpy(),
                                  tree["dec_layers"]["cross"]["wk"][1])
    np.testing.assert_array_equal(model.enc_pos.numpy(), tree["enc_pos"])
    wide = dataclasses.replace(bundle.cfg, n_enc_layers=3)
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_numpy(tree, wide, "cpu")
    with pytest.raises(ValueError, match="n_enc_layers"):
        bridge.numpy_from_params(model, wide)
    bad = _np_tree(p)
    del bad["dec_layers"]["ln_x"]
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_numpy(bad, bundle.cfg, "cpu")
    bad = _np_tree(p)
    bad["enc_pos"] = bad["enc_pos"][:-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(bad, bundle.cfg, "cpu")

"""The port's training stack (repro_torch.training, core.router, the
teacher-forced forward and the checkpoint bridge) against the JAX
package's on bridged weights and identical batches: AdamW within 1e-6,
the schedule within 1e-7, teacher-forced logits within ATOL, losses
within 1e-4 relative, router scores within 1e-4, and a checkpoint written
by the port read by the reference. fp32 at "highest" matmul precision on
both sides."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import router as jax_router
from repro.core.experiment import TIERS
from repro.core.quality import scorer_loglik as jax_scorer_loglik
from repro.data import tokenizer as jax_tok
from repro.data.tasks import generate_dataset, lm_training_arrays
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.models.common import softmax_xent as jax_softmax_xent
from repro.training import optim as jax_optim
from repro.training import checkpoint as jax_checkpoint
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import train_lm as jax_train_lm
from repro_torch import bridge
from repro_torch.core import router
from repro_torch.core.quality import scorer_loglik
from repro_torch.models.common import softmax_xent
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig, init_router_encoder
from repro_torch.models.model import build_model
from repro_torch.training import optim
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.trainer import (TrainConfig, seeded_init,
                                          train_lm, trainable)
from conftest import tiny_cfg

ATOL = 1e-4      # logits: fp32, another summation order
ADAM_TOL = 1e-6  # one AdamW update: elementwise fp32
LR_TOL = 1e-7    # the schedule: a few fp32 operations on scalars
LOSS_RTOL = 1e-4  # losses after steps: gradients differ in the last bits
SCORE_TOL = 1e-4  # router scores after an epoch of steps


@pytest.fixture(autouse=True)
def highest_precision():
    """fp32 matmuls at full precision on both sides, one PyTorch thread."""
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


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


def _lm_pair(cfg, seed=0):
    """(reference bundle, reference params, port bundle, port module on
    the same weights). The port draws the weights and the bridge carries
    them across (``numpy_from_params``), which costs no JAX compile."""
    pcfg = _port_cfg(cfg)
    bundle = build_model(pcfg)
    port = bundle.init(torch.Generator().manual_seed(seed), "cpu")
    p = jax.tree_util.tree_map(jnp.asarray,
                               bridge.numpy_from_params(port, pcfg))
    return jax_build_model(cfg), p, bundle, port


def _by_name(tree, cfg):
    """A reference tree as the port's {parameter name: array}."""
    return bridge._state_from_tree(_np_tree(tree), cfg.n_layers)


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("grad_scale,state_dtype", [
    (1e-3, "float32"), (10.0, "float32"), (10.0, "bfloat16")],
    ids=["unclipped", "clipped", "bf16_moments"])
def test_adamw_step_matches_reference(grad_scale, state_dtype):
    """One AdamW step on a bridged decoder's params with random grads
    (the clipped case scales them past grad_clip): params and moments
    within ADAM_TOL; bf16 moments within one bf16 rounding step (2^-8
    relative), since fp32 values a bit apart may round to neighbouring
    bf16 values."""
    cfg = tiny_cfg("dense", qkv_bias=True)
    _, p, _, port = _lm_pair(cfg)
    rng = np.random.default_rng(0)
    g = jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape) * grad_scale).astype(np.float32),
        _np_tree(p))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4, state_dtype=state_dtype)
    jcfg, pcfg = jax_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    params = dict(port.named_parameters())
    jstate, state = jax_optim.init_opt_state(p, jcfg), \
        optim.init_opt_state(params, pcfg)
    p, jstate, jm = jax.jit(jax_optim.adamw_update, static_argnums=3)(
        p, jax.tree_util.tree_map(jnp.asarray, g), jstate, jcfg)
    params, state, m = optim.adamw_update(
        params, {k: torch.tensor(v) for k, v in
                 bridge._state_from_tree(g, cfg.n_layers).items()},
        state, pcfg)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert float(m["lr"]) == float(jm["lr"])
    assert state["step"] == int(jstate["step"]) == 1
    moment_rtol = 2.0 ** -8 if state_dtype == "bfloat16" else 0.0
    for what, want, got, rtol in (
            ("params", p, params, 0.0), ("m", jstate["m"], state["m"],
                                         moment_rtol),
            ("v", jstate["v"], state["v"], moment_rtol)):
        want = _by_name(want, cfg)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(
                got[k].float().numpy(), np.asarray(want[k], np.float32),
                atol=ADAM_TOL, rtol=rtol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    jcfg, pcfg = jax_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    for step in range(0, 130, 3):
        np.testing.assert_allclose(float(optim.lr_at(pcfg, step)),
                                   float(jax_optim.lr_at(jcfg, step)),
                                   atol=LR_TOL, rtol=0)
    assert float(optim.lr_at(pcfg, 0)) < float(optim.lr_at(pcfg, 9))
    if schedule == "cosine":   # the 0.1 floor past the end
        assert float(optim.lr_at(pcfg, 10)) >= float(optim.lr_at(pcfg, 99))
        np.testing.assert_allclose(float(optim.lr_at(pcfg, 500)), 1e-4,
                                   rtol=1e-6)


def test_grad_clip_applied_and_quadratic_descends():
    cfg = optim.AdamWConfig(lr=1e-3, grad_clip=1e-3, warmup_steps=1,
                            total_steps=10)
    params = {"w": torch.zeros(4)}
    state = optim.init_opt_state(params, cfg)
    _, _, m = optim.adamw_update(params, {"w": torch.full((4,), 1e6)}, state,
                                 cfg)
    assert float(m["grad_norm"]) > 1e5
    assert float(params["w"].abs().max()) < 1.0
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.init_opt_state(params, cfg)
    for _ in range(200):
        optim.adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.5


# ------------------------------------------------------- teacher forcing
@pytest.mark.parametrize("tier", list(TIERS))
def test_decoder_forward_matches_reference(tier):
    """Teacher-forced logits of each pipeline tier (head_dim 16, 16, 32,
    24; tied, padded vocab) on bridged weights, tail masked as the
    reference masks it."""
    cfg = TIERS[tier][0]
    m, p, bundle, port = _lm_pair(cfg, seed=1)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 40)).astype(np.int32)
    want, waux = m.forward(p, {"tokens": jnp.asarray(tokens)})
    got, aux = bundle.forward(port, {"tokens": torch.tensor(tokens)})
    assert got.shape == want.shape and float(aux) == float(waux) == 0.0
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V],
                               atol=ATOL)
    np.testing.assert_array_equal(got[..., V:].numpy(),
                                  np.asarray(want)[..., V:])


def test_softmax_xent_matches_reference_and_masks_the_tail():
    cfg = TIERS["small"][0]
    _, _, bundle, port = _lm_pair(cfg, seed=2)
    arrays = lm_training_arrays(generate_dataset(np.random.default_rng(0), 6))
    batch = {k: torch.tensor(v) for k, v in arrays.items()}
    with trainable(port):
        logits, _ = bundle.forward(port, batch)
        loss = softmax_xent(logits, batch["labels"], batch["loss_mask"])
        (g,) = torch.autograd.grad(loss, [logits])
    assert not port.embed.table.requires_grad
    assert (g[..., cfg.vocab_size:] == 0).all()   # the tail takes no mass
    for mask in (arrays["loss_mask"], None):
        want = jax_softmax_xent(jnp.asarray(logits.detach().numpy()),
                                jnp.asarray(arrays["labels"]),
                                None if mask is None else jnp.asarray(mask))
        got = softmax_xent(logits.detach(), batch["labels"],
                           None if mask is None else torch.tensor(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_ssm_forward_names_its_slice():
    """The SSM family's teacher-forced forward (``ssm_forward`` under
    autograd, since the MoE and hybrid slice) against the reference's on
    bridged weights: logits within ATOL over a sequence past one SSD
    chunk, aux zero, and the loss gradient of every parameter within ATOL
    of ``jax.grad`` on the same batch."""
    cfg = tiny_cfg("ssm")
    m, p, bundle, port = _lm_pair(cfg, seed=6)
    tokens = np.random.default_rng(7).integers(
        4, cfg.vocab_size, (2, 21)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)

    def jloss(p):
        logits, _ = m.forward(p, {"tokens": jnp.asarray(tokens)})
        return jax_softmax_xent(logits, jnp.asarray(labels)), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p)
    params = dict(port.named_parameters())
    with trainable(port):
        logits, aux = bundle.forward(port, {"tokens": torch.tensor(tokens)})
        grads = torch.autograd.grad(
            softmax_xent(logits, torch.tensor(labels)), list(params.values()))
    assert float(aux) == 0.0
    V = cfg.vocab_size
    np.testing.assert_allclose(logits.detach()[..., :V].numpy(),
                               np.asarray(want)[..., :V], atol=ATOL)
    jg = _by_name(jgrads, cfg)
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), jg[name], atol=ATOL,
                                   err_msg=name)


def test_scorer_loglik_matches_reference():
    cfg = TIERS["tiny"][0]
    m, p, bundle, port = _lm_pair(cfg, seed=3)
    rng = np.random.default_rng(4)
    q = rng.integers(4, cfg.vocab_size, (4, 10)).astype(np.int32)
    r = rng.integers(4, cfg.vocab_size, (4, 6)).astype(np.int32)
    rm = (np.arange(6)[None] < np.array([[6], [3], [1], [0]])).astype(
        np.float32)
    want = jax_scorer_loglik(m, p, jnp.asarray(q), jnp.asarray(r),
                             jnp.asarray(rm))
    np.testing.assert_allclose(scorer_loglik(bundle, port, q, r, rm), want,
                               atol=ATOL)


# --------------------------------------------------------------- trainers
def test_train_lm_steps_match_reference():
    """Three train_lm steps from bridged weights: the same rows (the same
    numpy draws), losses within LOSS_RTOL, and the trained weights'
    logits within ATOL; the module comes back with gradients off."""
    cfg = TIERS["small"][0]
    m, p, bundle, port = _lm_pair(cfg, seed=5)
    arrays = lm_training_arrays(generate_dataset(np.random.default_rng(0),
                                                 40))
    kw = dict(steps=3, batch_size=8, lr=2e-3, log_every=1, seed=3)
    jp, jhist = jax_train_lm(m, arrays, JaxTrainConfig(**kw), params=p)
    trained, hist = train_lm(bundle, arrays, TrainConfig(**kw), params=port)
    assert trained is port
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=LOSS_RTOL)
    assert not any(t.requires_grad for t in port.parameters())
    tokens = arrays["tokens"][:4]
    want, _ = m.forward(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = bundle.forward(port, {"tokens": torch.tensor(tokens)})
    assert not got.requires_grad
    np.testing.assert_allclose(got[..., :cfg.vocab_size].numpy(),
                               np.asarray(want)[..., :cfg.vocab_size],
                               atol=ATOL)


@pytest.mark.parametrize("what", ["lm", "router"])
def test_seeded_init_is_the_cpu_draw_on_every_device(what):
    """``train_lm``'s and ``train_router``'s fresh weights are the CPU
    generator's draw from the seed, moved to the device, so a seed names
    the same weights on the card as on the CPU (a CUDA generator draws
    another stream). The "meta" device has no generator at all: the draw
    never happens on the target device."""
    if what == "lm":
        init = build_model(_port_cfg(TIERS["tiny"][0])).init
    else:
        rcfg = RouterConfig(vocab_size=64, n_layers=1, d_model=32,
                            n_heads=2, d_ff=64)
        init = lambda g, d: init_router_encoder(rcfg, g, d)
    want = init(torch.Generator().manual_seed(7), "cpu").state_dict()
    got = seeded_init(init, 7, "cpu").state_dict()
    meta = seeded_init(init, 7, "meta").state_dict()
    assert got.keys() == want.keys() == meta.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(meta[k].device.type == "meta"
               and meta[k].shape == want[k].shape for k in want)


def test_bce_loss_matches_reference():
    logits = np.array([0.0, 10.0, -10.0, 2.5], np.float32)
    for y in ([0.5, 1.0, 0.0, 0.3], [0.5, 0.0, 1.0, 0.9]):
        y = np.asarray(y, np.float32)
        np.testing.assert_allclose(
            float(router.bce_loss(torch.tensor(logits), torch.tensor(y))),
            float(jax_router.bce_loss(jnp.asarray(logits), jnp.asarray(y))),
            rtol=1e-6)


def test_train_router_epoch_matches_reference():
    """One train_router epoch from the reference's own initial encoder,
    bridged: the same epoch order, train and val losses within LOSS_RTOL,
    val scores within SCORE_TOL; the returned module holds the best-val
    weights and has gradients off."""
    rcfg = JaxRouterConfig(vocab_size=jax_tok.VOCAB_SIZE, n_layers=2,
                           d_model=32, n_heads=4, d_ff=64)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    rng = np.random.default_rng(6)
    tr, va = generate_dataset(rng, 96), generate_dataset(rng, 40)
    y = rng.uniform(size=96).astype(np.float32)
    yv = rng.uniform(size=40).astype(np.float32)
    tcfg_kw = dict(epochs=1, batch_size=16, lr=1e-3, seed=4)
    init = jax.jit(jax_init_router, static_argnums=1)(
        jax.random.PRNGKey(tcfg_kw["seed"]), rcfg)
    jp, jhist = jax_router.train_router(
        rcfg, tr.query, tr.query_mask, y,
        jax_router.RouterTrainConfig(**tcfg_kw),
        val=(va.query, va.query_mask, yv))
    port, hist = router.train_router(
        prcfg, tr.query, tr.query_mask, y, router.RouterTrainConfig(**tcfg_kw),
        val=(va.query, va.query_mask, yv),
        params=bridge.params_from_numpy(_np_tree(init), prcfg, "cpu"))
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        router.score_dataset(port, prcfg, va.query, va.query_mask),
        jax_router.score_dataset(jp, rcfg, va.query, va.query_mask),
        atol=SCORE_TOL)
    assert not any(t.requires_grad for t in port.parameters())


def test_train_router_returns_a_copy_of_the_best_epoch():
    """The best-val checkpoint is a copy taken at its epoch: the returned
    module's val loss is the history's minimum, not the last epoch's."""
    prcfg = RouterConfig(vocab_size=jax_tok.VOCAB_SIZE, n_layers=1,
                         d_model=32, n_heads=2, d_ff=64)
    rng = np.random.default_rng(7)
    tr, va = generate_dataset(rng, 64), generate_dataset(rng, 32)
    y = (tr.task <= 1).astype(np.float32)
    yv = (va.task <= 1).astype(np.float32)
    # a learning rate that overshoots, so some later epoch is worse
    port, hist = router.train_router(
        prcfg, tr.query, tr.query_mask, y,
        router.RouterTrainConfig(epochs=4, batch_size=16, lr=1.0, seed=2),
        val=(va.query, va.query_mask, yv), device="cpu")
    assert len(hist["val_loss"]) == 4
    assert min(hist["val_loss"]) < hist["val_loss"][-1]
    scores = torch.tensor(router.score_dataset(port, prcfg, va.query,
                                               va.query_mask))
    vloss = float(router.bce_loss(torch.logit(scores.double()).float(),
                                  torch.tensor(yv)))
    np.testing.assert_allclose(vloss, min(hist["val_loss"]), rtol=1e-4)


# -------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_port_to_reference(tmp_path):
    """A port module -> numpy_from_params -> save_checkpoint -> the
    reference's load_checkpoint: identical tensors and the same logits;
    and back through the port's loader and params_from_numpy."""
    cfg = TIERS["medium"][0]
    m, _, bundle, _ = _lm_pair(cfg)
    port = bundle.init(torch.Generator().manual_seed(9), "cpu")
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, bridge.numpy_from_params(port, _port_cfg(cfg)))
    loaded = jax_checkpoint.load_checkpoint(path)
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = m.forward(loaded, {"tokens": jnp.asarray(tokens)})
    got, _ = bundle.forward(port, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(got[..., :cfg.vocab_size].numpy(),
                               np.asarray(want)[..., :cfg.vocab_size],
                               atol=ATOL)
    back = bridge.params_from_numpy(bridge.load_checkpoint(path),
                                    _port_cfg(cfg), "cpu")
    for (name, a), (_, b) in zip(port.state_dict().items(),
                                 back.state_dict().items()):
        assert torch.equal(a, b), name


def test_numpy_from_params_inverts_the_bridge_for_the_router():
    rcfg = JaxRouterConfig(vocab_size=64, n_layers=3, d_model=32, n_heads=4,
                           d_ff=64)
    # the reference's tree structure and shapes, filled with numpy draws
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype),
        jax.eval_shape(lambda k: jax_init_router(k, rcfg),
                       jax.random.PRNGKey(1)))
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    back = bridge.numpy_from_params(
        bridge.params_from_numpy(tree, prcfg, "cpu"), prcfg)
    assert jax_checkpoint.trees_equal(back, tree)


def test_numpy_from_params_copies_the_weights():
    """The tree must not share memory with the module: training updates
    the parameters in place (on the CPU ``.numpy()`` would alias them)."""
    cfg = _port_cfg(tiny_cfg("dense"))
    model = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    tree = bridge.numpy_from_params(model, cfg)
    before = tree["embed"]["table"].copy()
    with torch.no_grad():
        model.embed.table.add_(1.0)
        model.layers[0].ln1.scale.add_(1.0)
    np.testing.assert_array_equal(tree["embed"]["table"], before)
    assert (tree["layers"]["ln1"]["scale"][0] == 1.0).all()

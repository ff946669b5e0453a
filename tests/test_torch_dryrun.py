"""The port's dry-run tooling (repro_torch.launch.{inputs,steps,roofline,
cost_analysis,dryrun}) against the reference's: the config helpers and
shapes equal, the three steps on bridged weights at 1e-5, chunked plain
attention at 1e-6, remat on and off equal, the dispatch counter against
the analytic count and the reference's HLO analysis, the reference's MoE
compute the sharded path takes, and a mini dry run over 8 fake ranks."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jax_get_config
from repro.launch import hlo_analysis
from repro.launch import inputs as jax_inputs
from repro.launch import roofline as jax_roofline
from repro.launch import steps as jax_steps
from repro.models import attention as jax_attention
from repro.models import moe as jax_moe
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro.models.model import build_model as jax_build_model
from repro.training.optim import AdamWConfig as JaxAdamWConfig
from repro.training.optim import init_opt_state as jax_init_opt_state
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import cost_analysis, inputs, roofline, steps
from repro_torch.models import attention, moe
from repro_torch.models.config import ArchConfig, INPUT_SHAPES
from repro_torch.models.model import build_model
from repro_torch.training.optim import AdamWConfig, init_opt_state
from repro_torch.training.trainer import trainable
from conftest import tiny_cfg

TOL = 1e-5


@pytest.fixture(autouse=True)
def highest_precision():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


def _pair(cfg, seed=0):
    pcfg = ArchConfig(**dataclasses.asdict(cfg))
    bundle = build_model(pcfg)
    m = bundle.init(torch.Generator().manual_seed(seed), "cpu")
    p = jax.tree_util.tree_map(jnp.asarray, bridge.numpy_from_params(m, pcfg))
    return pcfg, bundle, m, jax_build_model(cfg), p


def test_config_helpers_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_IDS:
        jc, pc = jax_get_config(arch), get_config(arch)
        assert pc.active_param_count() == jc.active_param_count(), arch
        assert pc.has_subquadratic_path == jc.has_subquadratic_path
        assert pc.is_attention_free == jc.is_attention_free
        assert pc.has_recurrent_layers == jc.has_recurrent_layers
        assert pc.is_global_layer_flags() == jc.is_global_layer_flags()
        for name, sh in INPUT_SHAPES.items():
            jsh = JAX_SHAPES[name]
            assert dataclasses.asdict(inputs.dryrun_config(pc, sh)) == \
                dataclasses.asdict(jax_inputs.dryrun_config(jc, jsh))
            assert inputs.needs_windowed_decode(pc, sh) == \
                jax_inputs.needs_windowed_decode(jc, jsh)
            assert roofline.model_flops(pc, sh) == \
                jax_roofline.model_flops(jc, jsh)
            assert steps.trip_counts(pc, sh.kind) == \
                jax_steps.trip_counts(jc, sh.kind)
    rl = roofline.roofline_terms(get_config("qwen1.5-32b"),
                                 INPUT_SHAPES["decode_32k"],
                                 flops_per_dev=989e12, coll_bytes_per_dev=0,
                                 hbm_bytes_per_dev=3.35e12 * 2, n_chips=256)
    assert (rl.compute_s, rl.memory_s, rl.dominant) == (1.0, 2.0, "memory")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_equal_reference(arch):
    for name in INPUT_SHAPES:
        sh, jsh = INPUT_SHAPES[name], JAX_SHAPES[name]
        pc = inputs.dryrun_config(get_config(arch), sh)
        jc = jax_inputs.dryrun_config(jax_get_config(arch), jsh)
        got = inputs.input_specs(pc, sh)
        want = jax_inputs.input_specs(jc, jsh)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (name, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        if sh.kind != "decode":
            continue
        got = inputs.cache_specs(pc, sh)
        want = jax_inputs.cache_specs(jc, jsh)
        assert got["pos"] == sh.seq_len - 1
        for k in set(want) - {"pos"}:
            assert tuple(got[k].shape) == want[k].shape, (name, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_build_step_matches_reference(family):
    """Train (loss and one AdamW update), prefill (logits and cache) and
    decode (logits and cache) of the port's steps against the reference's
    on the same weights, fp32 moments."""
    cfg = tiny_cfg(family)
    pcfg, bundle, m, jb, p = _pair(cfg)
    rng = np.random.default_rng(0)
    B, S = 2, 16
    tokens = rng.integers(3, 256, (B, S)).astype(np.int32)
    labels = rng.integers(3, 256, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    ocfg, jocfg = AdamWConfig(), JaxAdamWConfig()
    # prefill and decode first (the train step updates the weights)
    logits, cache = steps.build_prefill_step(bundle, S + 2)(
        m, {"tokens": torch.as_tensor(tokens)})
    jl, jc = jax_steps.build_prefill_step(jb, S + 2)(
        p, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), TOL, TOL)
    keys = [k for k in jc if k != "pos"]
    for k in keys:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   TOL, TOL)
    tok = logits.argmax(-1, keepdim=True).int()
    logits, cache = steps.build_decode_step(bundle, False)(m, cache, tok)
    jl, jc = jax_steps.build_decode_step(jb, False)(p, jc,
                                                     jnp.asarray(tok.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), TOL, TOL)
    for k in keys:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   TOL, TOL)
    assert cache["pos"] == int(jc["pos"]) == S + 1
    batch = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    opt = init_opt_state(dict(m.named_parameters()), ocfg)
    _, opt, loss = steps.build_train_step(bundle, ocfg)(
        m, opt, {k: torch.as_tensor(v) for k, v in batch.items()})
    jp, jopt, jloss = jax_steps.build_train_step(jb, jocfg)(
        p, jax_init_opt_state(p, jocfg),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    got = bridge.numpy_from_params(m, pcfg)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), TOL, TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert opt["step"] == 1 and int(jopt["step"]) == 1


@pytest.mark.parametrize("window", [0, 6])
def test_chunked_training_attention(window):
    """Query chunks of 8 == one chunk == the reference's chunked
    attention_forward, at 1e-6."""
    cfg = tiny_cfg(attn_chunk=8, sliding_window=window)
    pcfg, _, m, _, p = _pair(cfg)
    x = np.random.default_rng(2).standard_normal((2, 32, 64)) \
        .astype(np.float32)
    a = m.layers[0].attn
    with torch.no_grad():
        chunked = attention.training_attention(a, torch.as_tensor(x), pcfg,
                                               is_global=not window)
        whole = attention.training_attention(
            a, torch.as_tensor(x), dataclasses.replace(pcfg, attn_chunk=32),
            is_global=not window)
    ref = jax_attention.attention_forward(
        p["layers"]["attn"] and jax.tree_util.tree_map(lambda t: t[0],
                                                       p["layers"]["attn"]),
        jnp.asarray(x), cfg, is_global=not window)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), 1e-6, 1e-6)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref), 1e-6, 1e-6)


@pytest.mark.parametrize("family", ["dense", "hybrid", "audio"])
def test_remat_gives_same_loss_and_grads(family):
    cfg = tiny_cfg(family)
    pcfg, bundle, m, _, _ = _pair(cfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(rng.integers(3, 256, (2, 16))),
             "labels": torch.as_tensor(rng.integers(3, 256, (2, 16)))}
    if family == "audio":
        batch["enc_embeds"] = torch.as_tensor(
            rng.standard_normal((2, 16, 64)).astype(np.float32))
    out = []
    for remat in (False, True):
        b = build_model(dataclasses.replace(pcfg, remat=remat))
        with trainable(m):
            logits, aux = b.forward(m, batch)
            loss = torch.nn.functional.cross_entropy(
                logits.flatten(0, 1), batch["labels"].flatten()) + aux
            grads = torch.autograd.grad(loss, list(m.parameters()))
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    for g0, g1 in zip(out[0][1], out[1][1]):
        assert torch.equal(g0, g1)


def test_cost_counter_counts_matmul_loop():
    """L matmuls (M, K) @ (K, N): the counter's FLOPs equal 2·M·K·N·L and
    the reference's hlo_analysis of the same loop compiled by JAX."""
    M, K, N, L = 8, 32, 16, 5
    a = np.random.default_rng(4).standard_normal((M, K)).astype(np.float32)
    ws = np.random.default_rng(5).standard_normal((L, K, N)) \
        .astype(np.float32)

    def loop(a, ws):
        out = []
        for w in ws:
            out.append(a @ w)
        return torch.stack(out)

    _, costs = cost_analysis.analyze(loop, torch.as_tensor(a),
                                     torch.as_tensor(ws))
    assert costs.flops == 2 * M * K * N * L
    assert costs.collective_bytes == 0 and costs.peak_bytes > 0

    def jloop(a, ws):
        return jax.lax.scan(lambda c, w: (c, a @ w), 0.0, ws)[1]

    txt = jax.jit(jloop).lower(jnp.asarray(a), jnp.asarray(ws)).compile() \
        .as_text()
    assert hlo_analysis.analyze(txt).flops == costs.flops


def test_moe_capacity_compute_matches_reference():
    """The capacity-buffer MoE the sharded and fake runs take equals the
    reference's moe_forward (drops included) at 1e-5, and
    ``capacity_dispatch`` (the dry run's selection) makes moe_forward
    take it."""
    cfg = tiny_cfg("moe", capacity_factor=0.5)
    pcfg, _, m, _, p = _pair(cfg)
    x = np.random.default_rng(6).standard_normal((3, 40, 64)) \
        .astype(np.float32)
    lp = jax.tree_util.tree_map(lambda t: t[0], p["layers"]["moe"])
    with torch.no_grad():
        y, aux = moe._moe_capacity(m.layers[0].moe, torch.as_tensor(x), pcfg)
        y2, _ = moe.moe_forward(m.layers[0].moe, torch.as_tensor(x), pcfg)
        with moe.capacity_dispatch():
            y3, aux3 = moe.moe_forward(m.layers[0].moe, torch.as_tensor(x),
                                       pcfg)
    assert torch.equal(y3, y) and float(aux3) == float(aux)
    jy, jaux = jax_moe.moe_forward(lp, jnp.asarray(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), TOL, TOL)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), TOL, TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)


MINI_DRYRUN = r"""
import json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.models.config import ArchConfig, InputShape
fake_process_group(8)
try:            # 8 ranks cannot hold the production mesh
    make_production_mesh()
    raise SystemExit("make_production_mesh did not refuse 8 ranks")
except RuntimeError as e:
    assert "need 256 ranks" in str(e), e
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
cfg = ArchConfig("mini", "moe", 4, 64, 4, 2, 128, 512, head_dim=16,
                 n_experts=4, top_k=2, dtype="bfloat16", vocab_pad_multiple=64,
                 attn_chunk=64)
shape = InputShape("mini", 128, 16, "train")
print(json.dumps(trace_step(cfg, shape, mesh)))
"""


def test_mini_dryrun_8_fake_ranks_subprocess():
    """A sharded MoE train step traced over a (4, 2) mesh of 8 fake ranks:
    its per-device param and moment bytes are the rules' arithmetic, and
    its FLOPs on 8 devices cover the one-device step's."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models.config import InputShape
    from repro_torch.sharding import rules
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", MINI_DRYRUN], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    cfg = ArchConfig("mini", "moe", 4, 64, 4, 2, 128, 512, head_dim=16,
                     n_experts=4, top_k=2, dtype="bfloat16",
                     vocab_pad_multiple=64, attn_chunk=64)
    # the same step on one device, while the subprocess runs
    one = trace_step(cfg, InputShape("mini", 128, 16, "train"))
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    rec = json.loads(stdout.strip().splitlines()[-1])
    sizes = {"data": 4, "model": 2}
    want = 0
    for name, (shape, dt) in inputs.params_specs(cfg).items():
        shard = 1
        for ax in rules.param_spec(name, shape, sizes):
            if ax is not None:
                shard *= sizes[ax]
        want += int(np.prod(shape)) * dt.itemsize // shard
    assert round(rec["memory"]["params_gb"] * 1e9) == want
    assert round(rec["memory"]["opt_gb"] * 1e9) == 2 * want   # bf16 m, v
    assert rec["flops_per_dev"] * 8 >= one["flops_per_dev"] > 0
    assert rec["collective_bytes_per_dev"] > 0
    assert one["collective_bytes_per_dev"] == 0
    assert rec["memory"]["peak_gb"] >= rec["memory"]["argument_gb"] > 0
    assert rec["while_trips"] == {"layers": 4}

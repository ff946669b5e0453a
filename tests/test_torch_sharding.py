"""The port's sharding (repro_torch.sharding) against the reference's:
``param_spec`` in both modes, ``cache_spec`` and ``batch_axes`` equal,
exactly, for every parameter and cache entry of every config; the
reference's divisibility and per-device budget checks restated on the
port; the sequence-sharded flash decode over 4 gloo ranks against the
reference's ``decode_attention`` (2e-5, the cache write exact); and
``constrain_batch`` the identity without a context."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jax_get_config
from repro.launch import inputs as jax_inputs
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.config import ArchConfig as JaxArchConfig
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro.models.model import build_model as jax_build_model
from repro.sharding import rules as jax_rules
from repro_torch.configs import get_config
from repro_torch.launch.inputs import cache_specs, dryrun_config, params_specs
from repro_torch.models.attention import Attention
from repro_torch.models.config import ArchConfig, INPUT_SHAPES
from repro_torch.models.common import init_params_
from repro_torch.sharding import context, rules

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _stacked(names):
    """How many leading scan-stack dims a reference param path has."""
    if names[0] in ("layers", "enc_layers", "dec_layers"):
        return 1
    if names[0] == "blocks":
        return 1 if names[1] == "attn" else 2
    return 0


def _port_name(names, n_stack):
    """The port's parameter name of a reference path: each stacked axis's
    index (0) after the path's first part and, for the hybrid's per-kind
    stacks, after the kind."""
    parts = list(names)
    if n_stack >= 1:
        parts.insert(1, "0")
    if n_stack == 2:
        parts.insert(3, "0")
    return ".".join(parts)


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_specs(request):
    arch = request.param
    jcfg = jax_inputs.dryrun_config(jax_get_config(arch),
                                    JAX_SHAPES["train_4k"])
    pcfg = dryrun_config(get_config(arch), INPUT_SHAPES["train_4k"])
    leaves = jax.tree_util.tree_flatten_with_path(
        jax_inputs.params_specs(jcfg))[0]
    return arch, jcfg, pcfg, leaves


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["default", "decode"])
def test_param_spec_equals_reference(arch_specs, mesh, mode):
    arch, _, pcfg, leaves = arch_specs
    port = params_specs(pcfg)
    sizes = MESHES[mesh]
    seen = set()
    for path, leaf in leaves:
        names = jax_rules._path_names(path)
        n = _stacked(names)
        ref = tuple(jax_rules.param_spec(path, leaf.shape, _FakeMesh(sizes),
                                         mode=mode))
        assert ref[:n] == (None,) * n, (arch, names, ref)
        name = _port_name(names, n)
        assert port[name][0] == tuple(leaf.shape[n:]), name
        got = rules.param_spec(name, leaf.shape[n:], sizes, mode=mode)
        assert got == ref[n:], (arch, name, got, ref)
        seen.add(name)
    # every port parameter is one of the reference's, by its rule's name
    assert {rules._names(p).__str__() for p in port} == \
        {rules._names(p).__str__() for p in seen}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_spec_equals_reference(arch_specs, mesh, shape):
    arch, jcfg, pcfg, _ = arch_specs
    sh = INPUT_SHAPES[shape]
    sizes = MESHES[mesh]
    ref = jax.eval_shape(lambda: jax_build_model(jcfg).init_cache(
        sh.global_batch, sh.seq_len))
    port = cache_specs(pcfg, sh)
    common = (set(ref) & set(port)) - {"pos"}
    assert common, arch
    for key in common:
        assert tuple(port[key].shape) == tuple(ref[key].shape), key
        want = jax_rules.cache_spec((jax.tree_util.DictKey(key),),
                                    ref[key].shape, _FakeMesh(sizes),
                                    sh.global_batch)
        got = rules.cache_spec(key, port[key].shape, sizes, sh.global_batch)
        assert got == tuple(want), (arch, key, got, want)
    assert rules.cache_spec("pos", (), sizes, sh.global_batch) == ()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axes_equal_reference(mesh):
    sizes = MESHES[mesh]
    for batch in (1, 2, 16, 32, 48, 128, 256, 512):
        assert rules.batch_axes(sizes, batch) == \
            jax_rules.batch_axes(_FakeMesh(sizes), batch), batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divisible(arch):
    """Every sharded dim divides its mesh axis (16/16)."""
    cfg = dryrun_config(get_config(arch), INPUT_SHAPES["train_4k"])
    sizes = MESHES["single"]
    n_sharded = 0
    for name, (shape, _) in params_specs(cfg).items():
        spec = rules.param_spec(name, shape, sizes)
        assert len(spec) == len(shape), (name, spec)
        for dim, ax in zip(shape, spec):
            if ax is not None:
                assert dim % sizes[ax] == 0, (name, shape, spec)
                n_sharded += 1
    assert n_sharded > 0, "no parameter got sharded at all"


@pytest.mark.parametrize("arch", ["grok-1-314b", "mistral-large-123b"])
def test_big_arch_fits_param_budget(arch):
    """2D-sharded bf16 params are far below a device's memory."""
    cfg = dryrun_config(get_config(arch), INPUT_SHAPES["prefill_32k"])
    sizes = MESHES["single"]
    per_dev = 0
    for name, (shape, dt) in params_specs(cfg).items():
        shard = 1
        for ax in rules.param_spec(name, shape, sizes):
            if ax is not None:
                shard *= sizes[ax]
        per_dev += np.prod(shape) * dt.itemsize / shard
    assert per_dev / 1e9 < 4.0, f"{per_dev / 1e9:.1f} GB/device"


def test_constrain_batch_is_identity_without_context():
    x = torch.randn(4, 3, 8)
    assert context.constrain_batch(x) is x
    assert context.constrain(x, "data", None, None) is x
    assert context.batch_axis_name() is None
    assert context.flash_decode_ctx() is None
    with context.activation_sharding(None, "data", seq_shard=True):
        assert context.batch_axis_name() == "data"
        assert context.constrain_batch(x) is x    # a plain tensor
    assert context.batch_axis_name() is None


GLOO = r"""
import copy, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def flash_decode_check(tmp, out):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.attention import Attention, decode_attention
    from repro_torch.models.config import ArchConfig
    from repro_torch.sharding.context import flash_decode
    d = np.load(f"{tmp}/in.npz")
    cfg = ArchConfig("t", "dense", 2, 64, 4, 2, 0, 256, head_dim=16,
                     attn_chunk=8)
    attn = Attention(cfg, "cpu")
    for n in ("wq", "wk", "wv", "wo"):
        getattr(attn, n).data.copy_(torch.as_tensor(d[n]))
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    for pos in (0, 7, 17, 31):
        kv = [distribute_tensor(torch.as_tensor(d[n]), mesh,
                                [Replicate(), Shard(1)]) for n in ("k", "v")]
        with flash_decode(mesh, None), implicit_replication(), \
                torch.no_grad():
            o = decode_attention(attn, torch.as_tensor(d["x"]), *kv, pos,
                                 cfg)
        out[f"out{pos}"] = o.full_tensor().numpy()
        out[f"k{pos}"] = kv[0].full_tensor().numpy()
        out[f"v{pos}"] = kv[1].full_tensor().numpy()
        out[f"local{pos}"] = np.array(kv[0].to_local().shape)


def steps_check(out):
    # the dry run's steps on a real (2, 2) mesh against one device
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import step_contexts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ArchConfig, InputShape
    from repro_torch.models.model import build_model
    from repro_torch.sharding import rules
    from repro_torch.training.optim import AdamWConfig, init_opt_state
    mesh = make_host_mesh(model=2, device="cpu")
    out["host_mesh"] = np.array(mesh.shape)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    for tag, cfg in (
            ("heads", ArchConfig("h", "dense", 2, 64, 4, 2, 128, 256,
                                 head_dim=16, vocab_pad_multiple=64,
                                 attn_chunk=8, remat=True)),
            ("seq", ArchConfig("s", "dense", 2, 60, 5, 5, 128, 250,
                               head_dim=12, qkv_bias=True,
                               vocab_pad_multiple=64, attn_chunk=8,
                               remat=True)),
            ("qheads", ArchConfig("g", "dense", 2, 64, 4, 1, 128, 256,
                                  head_dim=16, vocab_pad_multiple=64,
                                  attn_chunk=8, remat=True)),
            ("moe", ArchConfig("m", "moe", 2, 64, 4, 2, 64, 256, head_dim=16,
                               n_experts=4, top_k=2, vocab_pad_multiple=64,
                               attn_chunk=8, remat=True)),
            ("ssm", ArchConfig("x", "ssm", 2, 64, 0, 0, 0, 250, ssm_state=16,
                               ssm_headdim=16, ssm_chunk=8,
                               tie_embeddings=True, vocab_pad_multiple=64,
                               remat=True))):
        bundle = build_model(cfg)
        plain = bundle.init(torch.Generator().manual_seed(0), "cpu")
        sharded = copy.deepcopy(plain)
        sh = rules.params_shardings(dict(plain.named_parameters()), mesh)
        for name, p in list(sharded.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            setattr(sharded.get_submodule(mod), leaf, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, sh[name]),
                requires_grad=False))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(3, 250, (4, 16), generator=g)
        labels = torch.randint(3, 250, (4, 16), generator=g)
        rows = lambda t, shape: distribute_tensor(
            t, mesh, rules.batch_shardings({"t": t}, mesh, 4)["t"])
        pre, dec = InputShape("p", 16, 4, "prefill"), \
            InputShape("d", 20, 4, "decode")
        lp, cp = steps.build_prefill_step(bundle, 20)(plain,
                                                      {"tokens": tokens})
        with step_contexts(cfg, pre, mesh):
            ls, cs = steps.build_prefill_step(bundle, 20)(
                sharded, {"tokens": rows(tokens, pre)})
        tok = lp.argmax(-1, keepdim=True)
        dp, _ = steps.build_decode_step(bundle, False)(plain, cp, tok)
        with step_contexts(cfg, dec, mesh):
            ds, cs = steps.build_decode_step(bundle, False)(
                sharded, cs, rows(tok, dec))
        out[f"{tag}_prefill"] = np.stack([full(ls).numpy(), lp.numpy()])
        out[f"{tag}_decode"] = np.stack([full(ds).numpy(), dp.numpy()])
        key = "ssm_h" if cfg.family == "ssm" else "k"
        out[f"{tag}_cache"] = np.stack([full(cs[key]).numpy(),
                                        cp[key].numpy()])
        ocfg = AdamWConfig()
        batch = {"tokens": tokens, "labels": labels}
        tr = InputShape("t", 16, 4, "train")
        _, _, loss = steps.build_train_step(bundle, ocfg)(
            plain, init_opt_state(dict(plain.named_parameters()), ocfg),
            batch)
        with step_contexts(cfg, tr, mesh):
            _, _, sloss = steps.build_train_step(bundle, ocfg)(
                sharded, init_opt_state(dict(sharded.named_parameters()),
                                        ocfg),
                {k: rows(v, tr) for k, v in batch.items()})
        out[f"{tag}_loss"] = np.array([float(full(sloss)), float(loss)])
        for name, p in plain.named_parameters():
            got = full(dict(sharded.named_parameters())[name].detach())
            out[f"{tag}_param_{name}"] = np.stack([got.numpy(),
                                                   p.detach().numpy()])


def worker(rank, tmp):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    torch.set_num_threads(1)
    out = {}
    flash_decode_check(tmp, out)
    steps_check(out)
    if rank == 0:
        np.savez(f"{tmp}/out.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(sys.argv[1],), nprocs=4)
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The 4-rank gloo script's results: the flash decode on a (1, 4)
    mesh and the dry run's steps on a (2, 2) mesh."""
    tmp = tmp_path_factory.mktemp("gloo")
    jcfg = JaxArchConfig("t", "dense", 2, 64, 4, 2, 0, 256, head_dim=16,
                         attn_chunk=8)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    attn = init_params_(Attention(cfg, "cpu"),
                        torch.Generator().manual_seed(0))
    w = {n: getattr(attn, n).detach().numpy() for n in ("wq", "wk", "wv",
                                                        "wo")}
    rng = np.random.default_rng(1)
    B, S = 4, 32
    data = dict(k=rng.standard_normal((B, S, 2, 16)).astype(np.float32),
                v=rng.standard_normal((B, S, 2, 16)).astype(np.float32),
                x=rng.standard_normal((B, 1, 64)).astype(np.float32), **w)
    np.savez(tmp / "in.npz", **data)
    script = tmp / "gloo.py"
    script.write_text(GLOO)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), str(tmp)],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    return jcfg, data, np.load(tmp / "out.npz")


def test_flash_decode_seq_sharded_matches_reference(gloo):
    """Sequence-sharded flash decode on 4 gloo ranks == the reference's
    single-device decode at every shard's positions; the cache write is
    exact (each rank writes only the position it owns)."""
    jcfg, d, got = gloo
    p = {n: jnp.asarray(d[n]) for n in ("wq", "wk", "wv", "wo")}
    with jax.default_matmul_precision("highest"):
        for pos in (0, 7, 17, 31):
            ref_out, rk, rv = jax_decode_attention(
                p, jnp.asarray(d["x"]), jnp.asarray(d["k"]),
                jnp.asarray(d["v"]), jnp.array(pos, jnp.int32), jcfg)
            np.testing.assert_allclose(got[f"out{pos}"], np.asarray(ref_out),
                                       rtol=2e-5, atol=2e-5)
            np.testing.assert_array_equal(got[f"k{pos}"], np.asarray(rk))
            np.testing.assert_array_equal(got[f"v{pos}"], np.asarray(rv))
            assert tuple(got[f"local{pos}"]) == (4, 8, 2, 16)


@pytest.mark.parametrize("tag", ["heads", "qheads", "seq", "moe", "ssm"])
def test_sharded_steps_match_one_device(gloo, tag):
    """The dry run's prefill, decode and train steps over a real (2, 2)
    gloo mesh (weights by the rules, the step contexts of the dry run)
    against the same steps on one device: logits, cache, loss and every
    parameter after one AdamW update within 2e-5. "heads": 4 heads on
    "model"; "qheads": 4 query heads on "model" over 1 KV head, which each
    rank reads whole; "seq": 5 heads, so attention runs sequence-parallel
    in train and prefill and decode takes the flash decode; "moe": the
    capacity-buffer experts against the one-device kept-only products;
    "ssm": each rank's mixer on its rows, a tied and padded vocab."""
    _, _, got = gloo
    for what in ("prefill", "decode", "cache"):
        mesh_out, one = got[f"{tag}_{what}"]
        np.testing.assert_allclose(mesh_out, one, rtol=2e-5, atol=2e-5,
                                   err_msg=what)
    np.testing.assert_allclose(*got[f"{tag}_loss"], rtol=2e-5)
    assert tuple(got["host_mesh"]) == (2, 2)     # make_host_mesh(model=2)
    params = [k for k in got.files if k.startswith(f"{tag}_param_")]
    assert len(params) > 10
    for k in params:
        np.testing.assert_allclose(*got[k], rtol=2e-5, atol=2e-5, err_msg=k)

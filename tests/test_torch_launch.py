"""The port's launchers (``repro_torch.launch.serve`` and ``.train``),
``ArchConfig.reduced()`` and ``router_score`` against the JAX package: the
reduced configs and the tier helpers field by field, every refusal's
message, the port's ``main`` end to end on the CPU, the vlm and audio
refusal on both sides, and the checkpoint ``train_arch`` writes. The
serving half's parity is in tests/test_torch_launch_serving.py. fp32 at
"highest" matmul precision on both sides."""
import dataclasses
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.models import router_score as jax_router_score
from repro.training.checkpoint import save_checkpoint as jax_save_checkpoint
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve, train
from repro_torch.models.encoder import RouterConfig, router_score
from repro_torch.serving.pool import ContinuousPoolEngine
from repro_torch.serving.prefix import PrefixStats
from repro_torch.training.checkpoint import load_checkpoint
from test_torch_serving import _np_tree, highest_precision  # noqa: F401

# README's mixed pool, in the order that resolves cheapest -> priciest
MIXED = ("gemma3-4b", ("mamba2-130m", "qwen1.5-32b", "full"))


def _same(port_cfg, ref_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)


def _ref_main(module, argv, monkeypatch):
    """The reference launcher's ``main`` on ``argv`` (it reads sys.argv)."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    return module.main()


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_matches_reference(arch):
    """``ArchConfig.reduced()`` gives the reference's reduced config field
    by field, and the same parameter count."""
    cfg, ref = get_config(arch).reduced(), jax_get_config(arch).reduced()
    _same(cfg, ref)
    assert cfg.name == arch + "-smoke"
    assert cfg.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tier_helpers_match_reference(arch):
    """``_reduced``, ``scaled_sibling`` at every sibling scale,
    ``resolve_tiers`` of each scale alone and ``reduced_pair`` equal the
    reference's."""
    full, ref_full = serve._reduced(arch), jax_serve._reduced(arch)
    _same(full, ref_full)
    for name, factor in serve.SIBLING_SCALES.items():
        _same(serve.scaled_sibling(full, factor),
              jax_serve.scaled_sibling(ref_full, factor))
        (one,), (ref_one,) = (serve.resolve_tiers(arch, [name]),
                              jax_serve.resolve_tiers(arch, [name]))
        _same(one, ref_one)
    assert serve.scaled_sibling(full, 1) is full
    for a, b in zip(serve.reduced_pair(arch), jax_serve.reduced_pair(arch)):
        _same(a, b)


def test_readme_mixed_pool_resolves_as_the_reference():
    """The README's mixed pool resolves to the same three configs,
    cheapest first (218,176 < 341,248 < 892,416 parameters)."""
    cfgs = serve.resolve_tiers(*MIXED)
    for a, b in zip(cfgs, jax_serve.resolve_tiers(*MIXED)):
        _same(a, b)
    assert [c.param_count() for c in cfgs] == [218_176, 341_248, 892_416]


@pytest.mark.parametrize("arch,tiers", [
    ("qwen1.5-32b", ["half", "tiny"]),                        # unknown
    ("qwen1.5-32b", ["half", "qwen1.5-32b", "full"]),         # duplicate
    ("qwen1.5-32b", ["mamba2-130m", "gemma3-4b", "full"]),    # inverted
], ids=["unknown", "duplicate", "inverted"])
def test_resolve_tiers_refusals_match_reference(arch, tiers):
    with pytest.raises(SystemExit) as port:
        serve.resolve_tiers(arch, tiers)
    with pytest.raises(SystemExit) as ref:
        jax_serve.resolve_tiers(arch, tiers)
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------ refusals
REFUSALS = {
    "spec-gamma": ["--spec-gamma", "2"],
    "prefix-cache": ["--prefix-cache", "8"],
    "escalate": ["--escalate", "0.2"],
    "escalate-range": ["--continuous", "--escalate", "1.5"],
    "one-tier": ["--tiers", "full"],
    "k3-dense": ["--tiers", "quarter", "half", "full"],
    "k3-no-paged": ["--arch", "whisper-large-v3", "--tiers", "quarter",
                    "half", "full", "--continuous"],
    # README's second command as the README printed it
    "readme-order": ["--arch", "qwen1.5-32b", "--tiers", "mamba2-130m",
                     "gemma3-4b", "full", "--continuous"],
}


@pytest.mark.parametrize("case", REFUSALS)
def test_serve_refusals_match_reference(case, monkeypatch):
    """Every refusal that precedes training gives the reference's
    message, the port's launcher driven by argv, the reference's by
    sys.argv; neither trains."""
    argv = REFUSALS[case] + ["--steps", "1", "--requests", "1"]
    monkeypatch.setattr(serve, "train_tiers", None)   # must not be reached
    with pytest.raises(SystemExit) as port:
        serve.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(jax_serve, "train_lm", None)
    with pytest.raises(SystemExit) as ref:
        _ref_main(jax_serve, argv, monkeypatch)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("port,ref", [(serve, jax_serve), (train, jax_train)],
                         ids=["serve", "train"])
def test_help_lists_every_reference_flag_and_device(port, ref, monkeypatch,
                                                    capsys):
    """``--help`` of each port launcher lists every flag of the
    reference's, and ``--device`` besides."""
    flags = []
    for run in (lambda: port.main(["--help"]),
                lambda: _ref_main(ref, ["--help"], monkeypatch)):
        with pytest.raises(SystemExit) as done:
            run()
        assert done.value.code == 0
        flags.append(set(re.findall(r"--[a-z][a-z-]*",
                                    capsys.readouterr().out)))
    assert flags[0] == flags[1] | {"--device"}


def test_train_needs_arch_or_router(monkeypatch, capsys):
    """Both training launchers exit with argparse's usage error (code 2)
    when neither --arch nor --router is given."""
    with pytest.raises(SystemExit) as port:
        train.main([])
    with pytest.raises(SystemExit) as ref:
        _ref_main(jax_train, [], monkeypatch)
    assert port.value.code == ref.value.code == 2
    assert capsys.readouterr().err.count("need --arch or --router") == 2


def test_cuda_without_a_card_is_refused():
    """Asking for the card where there is none raises before any work; it
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--steps", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--arch", "qwen1.5-32b", "--steps", "1"])


@pytest.mark.parametrize("arch,needs", [
    ("whisper-large-v3", "enc_embeds"), ("internvl2-26b", "frontend_embeds")])
def test_token_only_families_are_refused_before_training(arch, needs,
                                                         monkeypatch):
    """Departure by design: the port's launchers refuse the audio and vlm
    families before training, naming build_generate_fn; the reference's
    launcher accepts them and fails in its first training step with a
    KeyError on the missing frontend input."""
    monkeypatch.setattr(serve, "train_tiers", None)
    for argv in (["--arch", arch], ["--arch", "qwen1.5-32b", "--tiers",
                                     "half", arch]):
        with pytest.raises(SystemExit, match="build_generate_fn"):
            serve.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match=needs):
        train.train_arch(arch, 1, None, device="cpu")
    with pytest.raises(KeyError, match=needs):
        jax_train.train_arch(arch, 1, None)


# ------------------------------------------------------------ router_score
def test_router_score_matches_reference():
    """``router_score`` is the sigmoid of ``router_encode``: the
    reference's p_w(x) within 1e-5 on bridged weights, at the launcher's
    router widths."""
    rcfg = JaxRouterConfig(vocab_size=48, n_layers=2, d_model=64, n_heads=4,
                           d_ff=256)
    p = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(5),
                                                   rcfg)
    pcfg = RouterConfig(**dataclasses.asdict(rcfg))
    port = bridge.params_from_numpy(_np_tree(p), pcfg, "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 48, (4, 20)).astype(np.int32)
    mask = (np.arange(20)[None] < np.array([[20], [9], [1], [14]])
            ).astype(np.float32)
    want = np.asarray(jax.jit(jax_router_score, static_argnums=3)(
        p, jnp.asarray(tokens), jnp.asarray(mask), rcfg))
    got = router_score(port, torch.tensor(tokens).long(), torch.tensor(mask),
                       pcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert ((got > 0) & (got < 1)).all()


def test_prefix_hit_rate():
    assert PrefixStats().hit_rate == 0.0
    assert PrefixStats(lookups=8, hits=2, misses=6).hit_rate == 0.25


# ------------------------------------------------------------ main, train
@pytest.mark.parametrize("argv", [
    [], ["--arch", MIXED[0], "--tiers", *MIXED[1], "--continuous",
         "--prefix-cache", "16", "--escalate", "0.25"]],
    ids=["dense", "continuous"])
def test_main_serves_on_the_cpu(argv, capsys):
    """The whole launcher on the CPU at two training steps and one sample
    a query: a row per tier and the cost-advantage line, 8 calls."""
    hy = serve.main(argv + ["--device", "cpu", "--steps", "2", "--requests",
                            "8", "--samples", "1"])
    out = capsys.readouterr().out
    meter = hy.meter if isinstance(hy, ContinuousPoolEngine) \
        else hy.meter.tiers
    tiers = meter.summary()
    assert len(tiers) == (3 if argv else 2)
    assert sum(r["calls"] for r in tiers.values()) == 8
    for name in tiers:
        assert re.search(rf"^  {re.escape(name)} +\d+ calls", out, re.M)
    assert "  cost advantage: " in out
    assert out.index("== training") < out.index("== serving")


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_train_arch_writes_the_reference_checkpoint(arch, tmp_path):
    """``launch.train --arch`` on the CPU writes a checkpoint with the
    keys and shapes of the reference's for the same config, and it loads
    back into a port module with the trained weights."""
    out = tmp_path / "port.npz"
    trained = train.main(["--arch", arch, "--steps", "2", "--device", "cpu",
                          "--out", str(out)])
    ref_cfg = jax_serve._reduced(arch)
    ref = tmp_path / "ref.npz"
    jax_save_checkpoint(str(ref), jax.jit(jax_build_model(ref_cfg).init)(
        jax.random.PRNGKey(0)))
    with np.load(out) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
    cfg = serve._reduced(arch)
    loaded = bridge.params_from_numpy(load_checkpoint(str(out)), cfg, "cpu")
    for (k, v), (k2, w) in zip(loaded.state_dict().items(),
                               trained.state_dict().items()):
        assert k == k2 and torch.equal(v, w), k

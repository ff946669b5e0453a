"""The port's SSD chunk scan (repro_torch.kernels.ssd_scan) and SSM mixer
(repro_torch.models.ssm) against the JAX package, on the CPU.

Kernel level: the plain versions against the JAX package's ``ref.py``, its
``ops.py`` wrapper and its Pallas kernel in interpret mode, over the launch
modes of test_torch_gpu.py (the shapes of tests/test_kernels.py's SSD
sweep, l = 1, dt = 0 padding, steep dA, mamba2-130m's widths), plus the
wrappers' device dispatch. Model level: ``ssd_chunked`` with ``h0`` (both
of the port's chunk schedules, against both of the reference's), exact
streaming, and the serving steps ``ssm_prefill_chunk`` and
``ssm_decode_step`` on bridged weights. The CUDA kernel is held against
the same launch modes on the card in test_torch_gpu.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan.kernel import ssd_chunk_scan as jax_ssd_kernel
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jax_ssd_ref
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro_torch import bridge
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import ssm
from repro_torch.models.config import ArchConfig
from test_torch_gpu import SSD_MODES, ssd_case, to_torch
from conftest import tiny_cfg

# fp32 against fp32, another summation order; outputs reach tens at the
# mamba2 widths, so the tolerance is relative as well
RTOL = ATOL = 1e-5


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


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("mode", sorted(SSD_MODES))
def test_ssd_plain_matches_jax_ref_and_pallas(mode):
    args = ssd_case(mode)
    y, st = ssd_ops.ssd_chunk_scan(*to_torch(args))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    jargs = [jnp.asarray(a) for a in args]
    for name, (jy, jst) in (
            ("ref", jax.jit(jax_ssd_ref)(*jargs)),
            ("pallas", jax.jit(lambda *a: jax_ssd_kernel(
                *a, interpret=True))(*jargs))):
        _close(y, jy, f"{mode} y vs {name}")
        _close(st, jst, f"{mode} state vs {name}")
    if SSD_MODES[mode][-1] == "pad":
        assert not st[-1].any(), "a dt = 0 row must add exactly 0"


@pytest.mark.parametrize("b,nc,l,H,P,N", [(2, 3, 32, 4, 16, 8),
                                          (2, 2, 1, 3, 16, 16)],
                         ids=["ops_shapes", "l1"])
def test_ssd_model_layout_matches_jax_ops(b, nc, l, H, P, N):
    """The model-layout entry against the reference's ``ops.ssd_chunk``
    (its Pallas kernel in interpret mode) and ``ssd_chunk_reference``, on
    the shapes of tests/test_kernels.py::test_ssd_ops_matches_model_
    reference and on one-position chunks."""
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((b, nc, l, H, P)).astype(np.float32)
    dts = rng.uniform(0.01, 0.2, (b, nc, l, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    dA = np.cumsum(dts * A, axis=2).astype(np.float32)
    Bs = rng.standard_normal((b, nc, l, N)).astype(np.float32)
    Cs = rng.standard_normal((b, nc, l, N)).astype(np.float32)
    args = (xs, dts, dA, Bs, Cs)
    y, st = ssd_ops.ssd_chunk(*to_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    for name, (jy, jst) in (
            ("ops", jax.jit(jax_ssd_ops.ssd_chunk)(*jargs)),
            ("reference", jax.jit(jax_ssm.ssd_chunk_reference)(*jargs))):
        _close(y, jy, f"y vs {name}")
        _close(st, jst, f"states vs {name}")


def test_cpu_wrappers_take_the_plain_version_without_launching():
    args = to_torch(ssd_case("sweep_l16"))
    n0 = ssd_ops.ssd_chunk_scan.launches
    ssd_ops.ssd_chunk_scan(*args)
    x, dt, da, B, C = args
    ssd_ops.ssd_chunk(x.movedim(1, 2)[None], dt[..., 0].movedim(1, 2)[None],
                      da[..., 0].movedim(1, 2)[None], B[None], C[None])
    assert ssd_ops.ssd_chunk_scan.launches == n0


def test_wrappers_refuse_shapes_the_kernel_does_not_take():
    x, dt, da, B, C = to_torch(ssd_case("sweep_l16"))
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk_scan(x, dt[:, :, :-1], da, B, C)
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk_scan(x, dt, da, B, C[..., :-1])
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk(x[None], dt[None], da[None], B[None], C[None])


# ------------------------------------------------------------- ssd_chunked
def _ssd_inputs(b=2, S=32, H=3, P=8, N=16, seed=0):
    """The inputs of tests/test_window_ssm_serving.py's streaming test."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, S, H, P)).astype(np.float32),
        dt=(rng.random((b, S, H)) * 0.1).astype(np.float32),
        A=-rng.random((H,)).astype(np.float32),
        B=rng.standard_normal((b, S, N)).astype(np.float32),
        C=rng.standard_normal((b, S, N)).astype(np.float32),
        h0=(rng.standard_normal((b, H, P, N)) * 0.1).astype(np.float32))


def _chunked_all_at_once(x, dt, A, B, C, chunk, h0):
    """The card's schedule of ``ssd_chunked`` (all chunks in one
    ``ssd_chunk`` call, then the recurrence), run on the CPU, where
    ``ssd_chunk`` takes the plain version."""
    b, S, H, P = x.shape
    nc, N = S // chunk, B.shape[-1]
    dts = dt.reshape(b, nc, chunk, H)
    y, final = ssm._chunks_at_once(
        x.reshape(b, nc, chunk, H, P), dts, torch.cumsum(dts * A, dim=2),
        B.reshape(b, nc, chunk, N), C.reshape(b, nc, chunk, N), h0)
    return y.reshape(b, S, H, P), final


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssd_chunked_with_h0_matches_reference(use_pallas):
    """Both of the port's chunk schedules (the CPU's chunk by chunk, and
    the card's all chunks at once) against the reference's jnp and Pallas
    (interpret) paths, entering from a non-zero state."""
    inp = _ssd_inputs()
    t = {k: torch.tensor(v) for k, v in inp.items()}
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    jy, jh = jax.jit(lambda x, dt, A, B, C, h0: jax_ssm.ssd_chunked(
        x, dt, A, B, C, 8, use_pallas=use_pallas, h0=h0))(
        j["x"], j["dt"], j["A"], j["B"], j["C"], j["h0"])
    for name, (y, h) in (
            ("chunk by chunk", ssm.ssd_chunked(
                t["x"], t["dt"], t["A"], t["B"], t["C"], 8, h0=t["h0"])),
            ("all at once", _chunked_all_at_once(
                t["x"], t["dt"], t["A"], t["B"], t["C"], 8, t["h0"]))):
        _close(y, jy, f"y, {name}")
        _close(h, jh, f"final state, {name}")


def test_ssd_chunked_streams_exactly():
    """One full-sequence call == two calls carrying the final state across,
    inside the port (tests/test_window_ssm_serving.py's contract)."""
    t = {k: torch.tensor(v) for k, v in _ssd_inputs().items()}
    x, dt, A, B, C = (t[k] for k in ("x", "dt", "A", "B", "C"))
    y_full, h_full = ssm.ssd_chunked(x, dt, A, B, C, 8)
    y1, h1 = ssm.ssd_chunked(x[:, :16], dt[:, :16], A, B[:, :16], C[:, :16],
                             8)
    y2, h2 = ssm.ssd_chunked(x[:, 16:], dt[:, 16:], A, B[:, 16:], C[:, 16:],
                             8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ mixer steps
@pytest.fixture(scope="module")
def mixer():
    """Layer 0's mixer of a bridged tiny SSM stack: (reference config, port
    config, reference params, port module)."""
    cfg = tiny_cfg("ssm")
    p = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(2))
    pcfg = ArchConfig(**dataclasses.asdict(cfg))
    port = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                    pcfg, "cpu")
    ref = jax.tree_util.tree_map(lambda a: a[0], p["layers"]["ssm"])
    return cfg, pcfg, ref, port.layers[0].ssm


def test_ssm_prefill_chunk_matches_reference(mixer):
    """A ragged chunk step from a carried state and conv tail, with a full
    row, a partial row and an n_new = 0 padding row: output, state and
    tail. The padding row's state comes out exactly h0 and its tail
    verbatim."""
    cfg, pcfg, ref, port = mixer
    B, C = 3, 8
    H, P, N = pcfg.ssm_nheads, pcfg.ssm_headdim, pcfg.ssm_state
    ch = pcfg.d_inner + 2 * N
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, C, pcfg.d_model)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    tail = rng.standard_normal((B, pcfg.ssm_conv_width - 1, ch)) \
        .astype(np.float32)
    n_new = np.array([8, 5, 0], np.int32)
    want = jax.jit(lambda *a: jax_ssm.ssm_prefill_chunk(ref, *a, cfg))(
        jnp.asarray(x), jnp.asarray(h0), jnp.asarray(tail),
        jnp.asarray(n_new))
    got = ssm.ssm_prefill_chunk(port, *to_torch((x, h0, tail, n_new)), pcfg)
    for what, g, w in zip(("y", "state", "tail"), got, want):
        _close(g, w, what)
    assert torch.equal(got[1][2], torch.tensor(h0[2])), "padding row state"
    assert torch.equal(got[2][2], torch.tensor(tail[2])), "padding row tail"


def test_ssm_decode_step_matches_reference(mixer):
    cfg, pcfg, ref, port = mixer
    B = 2
    H, P, N = pcfg.ssm_nheads, pcfg.ssm_headdim, pcfg.ssm_state
    ch = pcfg.d_inner + 2 * N
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, pcfg.d_model)).astype(np.float32)
    h = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    tail = rng.standard_normal((B, pcfg.ssm_conv_width - 1, ch)) \
        .astype(np.float32)
    want = jax.jit(lambda *a: jax_ssm.ssm_decode_step(ref, *a, cfg))(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(tail))
    got = ssm.ssm_decode_step(port, *to_torch((x, h, tail)), pcfg)
    for what, g, w in zip(("y", "state", "tail"), got, want):
        _close(g, w, what)

"""The port's dense-cache attention kernels (repro_torch.kernels
.flash_attention and .decode_attention).

On the CPU: each plain version against the JAX package's ``ref.py``, its
``ops.py`` wrappers and its Pallas kernel in interpret mode, over every
launch mode of ``analysis/pallas_check.py``'s flash and decode probes
(causal, causal with a window, non-causal, irregular S, G > 1, S not a
multiple of the CUDA tiles, head_dim 24, a validity row whose first key
block is all masked), plus the wrappers' device dispatch. The CUDA kernels
are held against the same cases on the card in test_torch_gpu.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.decode_attention import ops as jax_dec_ops
from repro.kernels.decode_attention.kernel import \
    decode_attention_gqa as jax_decode_kernel
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention import ops as jax_flash_ops
from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd as jax_flash_kernel
from repro.kernels.flash_attention.ref import attention_ref as jax_flash_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from test_torch_gpu import (DECODE_DENSE_MODES, FLASH_MODES,
                            decode_dense_case, flash_case, to_torch)

ATOL = 1e-5      # fp32 against fp32, another summation order


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


def _bhsd(a, H):
    """(B, S, K, D) numpy -> head-expanded (B*H, S, D)."""
    B, S, K, D = a.shape
    return np.repeat(a, H // K, axis=2).transpose(0, 2, 1, 3) \
        .reshape(B * H, S, D)


@pytest.mark.parametrize("mode", sorted(FLASH_MODES))
def test_flash_plain_matches_jax_ref_ops_and_pallas(mode):
    (q, k, v), kw = flash_case(mode)
    B, S, H, D = q.shape
    got = flash_ops.flash_attention(*to_torch((q, k, v)), **kw).numpy()
    # the reference's model-layout wrapper takes kv expanded to H heads
    want = np.asarray(jax_flash_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, H // k.shape[2], 2)),
        jnp.asarray(np.repeat(v, H // k.shape[2], 2)), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL)
    bq, bk, bv = _bhsd(q, H), _bhsd(k, H), _bhsd(v, H)
    got = flash_ops.flash_attention_bhsd(*to_torch((bq, bk, bv)), **kw)
    jargs = [jnp.asarray(a) for a in (bq, bk, bv)]
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_flash_ref(*jargs, **kw)), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_flash_kernel(*jargs, interpret=True, bq=8, bk=8, **kw)),
        atol=ATOL)


@pytest.mark.parametrize("mode", sorted(DECODE_DENSE_MODES))
def test_decode_plain_matches_jax_ref_ops_and_pallas(mode):
    """All three entries: the production (B, H, D) / raw-cache entry, the
    head-expanded model entry and the TPU kernel's (BK, G, D) contract."""
    q, k, v, valid = decode_dense_case(mode)
    B, S, K, D = k.shape
    G = q.shape[1] // K
    got = dec_ops.decode_attention_kv(*to_torch((q, k, v, valid))).numpy()
    want = np.asarray(jax_dec_ops.decode_attention_kv(
        *[jnp.asarray(a) for a in (q, k, v, valid)]))
    np.testing.assert_allclose(got, want, atol=ATOL)

    kx, vx = (np.repeat(a, G, axis=2) for a in (k, v))
    got = dec_ops.decode_attention(*to_torch((q[:, None], kx, vx, valid)))
    want = np.asarray(jax_dec_ops.decode_attention(
        *[jnp.asarray(a) for a in (q[:, None], kx, vx, valid)]))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    qg = q.reshape(B * K, G, D)
    kg, vg = (a.transpose(0, 2, 1, 3).reshape(B * K, S, D) for a in (k, v))
    vmask = np.repeat(valid, K, axis=0)
    got = dec_ops.decode_attention_gqa(*to_torch((qg, kg, vg, vmask)))
    jargs = [jnp.asarray(a) for a in (qg, kg, vg, vmask)]
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_decode_ref(*jargs)), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_decode_kernel(*jargs, bk=min(512, S), interpret=True)),
        atol=ATOL)


def test_cpu_wrappers_take_the_plain_version_without_launching():
    (q, k, v), kw = flash_case("gqa")
    dq, dk, dv, dvalid = decode_dense_case("gqa")
    f0 = flash_ops.flash_attention.launches
    d0 = dec_ops.decode_attention_kv.launches
    flash_ops.flash_attention(*to_torch((q, k, v)), **kw)
    dec_ops.decode_attention_kv(*to_torch((dq, dk, dv, dvalid)))
    assert flash_ops.flash_attention.launches == f0
    assert dec_ops.decode_attention_kv.launches == d0


def test_wrappers_refuse_shapes_the_kernels_do_not_take():
    (q, k, v), _ = flash_case("gqa")
    q, k, v = to_torch((q, k, v))
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k[:, :-1], v[:, :-1])
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q[:, :, :3], k, v)     # H % K != 0
    dq, dk, dv, dvalid = to_torch(decode_dense_case("gqa"))
    with pytest.raises(ValueError):
        dec_ops.decode_attention_kv(dq, dk, dv, dvalid[:, :-1])

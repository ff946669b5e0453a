"""The port's paged-attention kernels (repro_torch.kernels).

On the CPU: each plain version against the JAX package's ``ref.py`` and its
Pallas kernel in interpret mode, over every launch mode (full walk,
live-bounded walk, sliding window with a late first page, GQA groups,
ragged and idle slots, a non-power-of-two head_dim, and for prefill a
chunk that starts mid-context and ends before its width), plus the
wrappers' device dispatch. The CUDA kernels are held against the same
cases on the card in test_torch_gpu.py, which also builds them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_decode_attention.kernel import \
    paged_decode_attention_gqa as jax_decode_kernel
from repro.kernels.paged_decode_attention.ref import \
    paged_decode_attention_ref as jax_decode_ref
from repro.kernels.paged_prefill_attention.kernel import \
    paged_prefill_attention_gqa as jax_prefill_kernel
from repro.kernels.paged_prefill_attention.ref import \
    paged_prefill_attention_ref as jax_prefill_ref
from repro_torch.kernels.paged_decode_attention import ops as dec_ops
from repro_torch.kernels.paged_prefill_attention import ops as pre_ops
from test_torch_gpu import (DECODE_MODES, PREFILL_MODES, decode_case,
                            prefill_case, to_torch)

TOL = dict(rtol=3e-5, atol=3e-5)     # fp32, as tests/test_paged_kernel.py


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

@pytest.mark.parametrize("mode", sorted(DECODE_MODES))
def test_decode_plain_matches_jax_ref_and_pallas(mode):
    args, kw = decode_case(mode)
    got = dec_ops.paged_decode_attention_gqa(*to_torch(args), **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jax_decode_ref(*jargs, **kw))
    pallas = np.asarray(jax_decode_kernel(*jargs, interpret=True, **kw))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    if not kw["window"]:
        assert not got[-1].any(), "an idle slot must give exactly 0"


@pytest.mark.parametrize("mode", sorted(PREFILL_MODES))
def test_prefill_plain_matches_jax_ref_and_pallas(mode):
    args, kw = prefill_case(mode)
    got = pre_ops.paged_prefill_attention_gqa(*to_torch(args), **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jax_prefill_ref(*jargs, **kw))
    pallas = np.asarray(jax_prefill_kernel(*jargs, interpret=True, **kw))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    if not kw["window"]:
        assert not got[-1].any(), "an idle slot must give exactly 0"


def test_cpu_wrappers_take_the_plain_version_without_launching():
    d_args, d_kw = decode_case("live_bound")
    p_args, p_kw = prefill_case("live_bound")
    d0 = dec_ops.paged_decode_attention_gqa.launches
    p0 = pre_ops.paged_prefill_attention_gqa.launches
    out = dec_ops.paged_decode_attention_gqa(*to_torch(d_args), **d_kw)
    assert torch.equal(out, dec_ops.paged_decode_attention_ref(
        *to_torch(d_args), **d_kw))
    out = pre_ops.paged_prefill_attention_gqa(*to_torch(p_args), **p_kw)
    assert torch.equal(out, pre_ops.paged_prefill_attention_ref(
        *to_torch(p_args), **p_kw))
    assert dec_ops.paged_decode_attention_gqa.launches == d0
    assert pre_ops.paged_prefill_attention_gqa.launches == p0


@pytest.mark.parametrize("bad", [dict(pages_start=1), dict(pages_bound=7),
                                 dict(pages_bound=2, pages_start=2,
                                      window=8)])
def test_wrappers_refuse_unsound_walks(bad):
    d_args, _ = decode_case("live_bound")
    p_args, _ = prefill_case("live_bound")
    with pytest.raises(ValueError):
        dec_ops.paged_decode_attention_gqa(*to_torch(d_args), **bad)
    with pytest.raises(ValueError):
        pre_ops.paged_prefill_attention_gqa(*to_torch(p_args), **bad)

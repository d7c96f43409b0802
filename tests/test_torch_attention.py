"""The port's attention (min_tfs_client_tpu_torch.ops.attention) held
against the JAX package's on the CPU: its plain version, its dispatcher and
its kernel wrapper (which takes the plain version for a CPU tensor) against
the JAX `attention_reference` and against the Pallas `flash_attention` run
in interpret mode, on every dense case of tests/unit/test_attention.py.

Tolerances, max abs error: float32 inputs 2e-5 (summation order only);
bfloat16 inputs 2e-2 plus 1e-2 of the value, one to two bf16 ulps (the
Pallas kernel keeps P in f32 for the PV product, the references round it
to bf16 first).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from min_tfs_client_tpu_torch.ops import attention as port

# `min_tfs_client_tpu.ops` re-exports a function named `attention`.
jax_attn = importlib.import_module("min_tfs_client_tpu.ops.attention")

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}

# label -> (q shape, Skv, lengths, causal, causal_offset), after the dense
# cases of tests/unit/test_attention.py at smaller sizes.
CASES = {
    "plain": ((2, 3, 128, 32), 128, None, False, None),
    "causal": ((2, 3, 128, 32), 128, None, True, None),
    "lengths": ((2, 2, 128, 32), 128, [37, 128], False, None),
    "unaligned_causal": ((1, 2, 72, 32), 72, None, True, None),
    "right_aligned_single_query": ((2, 2, 1, 32), 64, None, True, None),
    "causal_offset_0": ((2, 2, 16, 32), 40, None, True, 0),
    "fully_masked_row": ((2, 2, 64, 32), 64, [0, 40], False, None),
}


def _inputs(case, dtype, seed=0):
    shape, skv, lengths, causal, offset = CASES[case]
    b, h, sq, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    kw = dict(causal=causal, causal_offset=offset)
    j = [jnp.asarray(x, dtype) for x in (q, k, v)]
    t = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    j_lens = None if lens is None else jnp.asarray(lens)
    t_lens = None if lens is None else torch.from_numpy(lens)
    return j, t, j_lens, t_lens, kw


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


PORT_FNS = {
    "attention_reference": port.attention_reference,
    "attention": port.attention,
    "flash_attention": port.flash_attention,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", sorted(PORT_FNS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax_reference(case, fn, dtype):
    j, t, j_lens, t_lens, kw = _inputs(case, dtype)
    want = jax_attn.attention_reference(*j, lengths=j_lens, **kw)
    got = PORT_FNS[fn](*t, lengths=t_lens, **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# The single-query case is outside the Pallas kernel's dispatch gate
# (Sq < 8) but the kernel itself takes it, as tests/unit does.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_pallas_kernel_interpret(case, dtype):
    j, t, j_lens, t_lens, kw = _inputs(case, dtype, seed=1)
    want = jax_attn.flash_attention(*j, lengths=j_lens, interpret=True, **kw)
    got = port.flash_attention(*t, lengths=t_lens, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_fully_masked_rows_are_zero():
    _, t, _, t_lens, kw = _inputs("fully_masked_row", "float32")
    for fn in PORT_FNS.values():
        out = fn(*t, lengths=t_lens, **kw).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out[0], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_dispatches_to_reference(dtype):
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
    want = jax_attn.attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                              bias=jnp.asarray(bias))
    got = port.attention(*(torch.from_numpy(x).to(getattr(torch, dtype))
                           for x in (q, k, v)), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_kernel_wrapper_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    neither the CPU nor a CUDA card is refused, never computed."""
    q = torch.empty((1, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        port.flash_attention(q, q, q)


def test_launch_counter_untouched_on_cpu():
    before = port.flash_attention.launches
    _, t, _, t_lens, kw = _inputs("lengths", "float32")
    port.flash_attention(*t, lengths=t_lens, **kw)
    assert port.flash_attention.launches == before

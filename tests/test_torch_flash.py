"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs.

Shapes the Pallas kernel accepts (its BlockSpecs need sq and sk divisible by
the block) are held against it; ragged shapes, which the port takes and the
Pallas kernel does not, against the JAX oracle ``ref.py``, which agrees with
the kernel wherever every query row sees a key. Tolerances are the JAX
suite's own (``tests/test_kernels.py``): 2e-5 in f32, 2e-2 in bf16.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention import ref as jax_ref
from repro_torch.kernels.flash_attention import ops

TOL = {"f32": 2e-5, "bf16": 2e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, sq, sk, hq, hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    jdt, tdt = DT[dtype]
    # round through the working dtype once so both sides see equal inputs
    j = [jnp.asarray(a, jdt) for a in arrs]
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _pallas(j, causal, window, block):
    return jax_ops.flash_attention(*j, causal=causal, window=window,
                                   impl="pallas", interpret=True,
                                   block_q=block, block_k=block)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", [
    (1, 256, 256, 4, 4, 64, True, None),      # MHA causal
    (2, 256, 256, 8, 2, 64, True, None),      # GQA 4:1
    (1, 512, 512, 4, 1, 128, True, 128),      # MQA + sliding window
    (1, 128, 128, 2, 2, 32, False, None),     # bidirectional
])
def test_plain_matches_pallas(b, sq, sk, hq, hkv, d, causal, window, dtype):
    j, t = _inputs(b, sq, sk, hq, hkv, d, dtype)
    got = ops.flash_attention(*t, causal=causal, window=window)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    _close(got, _pallas(j, causal, window, 128), dtype)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,oracle", [
    (1, 96, 160, 4, 2, 32, True, None, "pallas"),    # sq < sk
    (1, 160, 96, 4, 2, 32, True, None, "pallas"),    # sq > sk
    (1, 64, 96, 8, 1, 64, False, 48, "pallas"),      # window, no causal
    (1, 100, 100, 4, 1, 64, True, 16, "ref"),        # ragged, window
    (2, 37, 53, 4, 4, 32, False, None, "ref"),       # ragged, sq != sk
    (1, 1, 70, 8, 2, 128, False, None, "ref"),       # one query row
    (1, 1000, 1000, 8, 2, 128, True, None, "ref"),   # ragged admission
])
def test_ragged_and_unequal_lengths(b, sq, sk, hq, hkv, d, causal, window,
                                    oracle):
    j, t = _inputs(b, sq, sk, hq, hkv, d, "f32", seed=1)
    got = ops.flash_attention(*t, causal=causal, window=window)
    if oracle == "pallas":
        want = _pallas(j, causal, window, 32)
    else:
        with pytest.raises(AssertionError):     # the BlockSpec limit
            _pallas(j, causal, window, 32)
        want = jax_ref.flash_attention_ref(*j, causal=causal, window=window)
    _close(got, want, "f32")


def test_rows_without_a_visible_key_follow_the_kernel():
    """Rows that see no key (no causal mask, window 4, 16 queries over 8
    keys: rows 11-15) are zeros in the Pallas kernel (l = 0) and the mean of
    v in the JAX oracle, whose softmax runs over all -1e30 scores. The port
    follows the kernel (ROADMAP.md Queue 3, the flash disagreement)."""
    j, t = _inputs(1, 16, 8, 2, 1, 32, "f32", seed=2)
    got = ops.flash_attention(*t, causal=False, window=4)
    pallas = _pallas(j, False, 4, 512)
    oracle = np.asarray(jax_ref.flash_attention_ref(*j, causal=False,
                                                    window=4))
    _close(got, pallas, "f32")
    assert np.all(got[:, 11:].numpy() == 0)
    assert np.abs(oracle[:, 11:] - np.asarray(pallas)[:, 11:]).max() > 0.1


def test_validation_errors():
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="multiple of kv"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="head dim 48"):
        ops.flash_attention(torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                            torch.zeros(1, 8, 2, 48))
    with pytest.raises(ValueError, match="k and v"):
        ops.flash_attention(q, kv, torch.zeros(1, 9, 2, 32))
    with pytest.raises(ValueError, match="4-D"):
        ops.flash_attention(q[0], kv, kv)
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.flash_attention(q, kv, kv, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, kv, kv, impl="pallas")
    before = ops.flash_attention.launches
    ops.flash_attention(q, kv, kv)                # the CPU runs the plain version
    assert ops.flash_attention.launches == before

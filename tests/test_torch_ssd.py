"""The port's Mamba-2 SSD scan (``kernels/ssd_scan``) and block
(``models/ssm.py``) against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages. The
port's ``ssd`` (its plain version on the CPU) is held against
``ssd(impl="pallas", interpret=True)`` at the JAX suite's tolerances
(``tests/test_kernels.py``): 1e-4 for float32 inputs, 5e-2 for bf16, on y
and on the final state. The chunked algorithm is held against the O(l)
recurrence at 1e-3 (the JAX suite's, for the same comparison); the decode
step and the block in float32 at 1e-5.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import f32

from repro.config.registry import get_arch as jax_arch
from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan import ref as jax_ssd_ref
from repro.models import ssm as jssm
from repro_torch.config.registry import get_arch
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import ssm

TOL = {"f32": 1e-4, "bf16": 5e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, l, h, p, n, seed=0, dtype="f32", state=False):
    """x, B, C normal (rounded to `dtype` once, both packages get the
    rounded values), dt = softplus(normal), A = -exp(0.2 normal)."""
    rng = np.random.default_rng(seed)
    jdt = DT[dtype][0]

    def rounded(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.array(jnp.asarray(a, jdt).astype(jnp.float32))

    x = rounded(b, l, h, p)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.2 * rng.standard_normal(h)).astype(np.float32)
    B, C = rounded(b, l, n), rounded(b, l, n)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if state else None
    return x, dt, A, B, C, s0


def _torch(x, dt, A, B, C, s0, dtype="f32"):
    tdt = DT[dtype][1]
    t = torch.from_numpy
    return (t(x).to(tdt), t(dt), t(A), t(B).to(tdt), t(C).to(tdt),
            None if s0 is None else t(s0))


def _jax(x, dt, A, B, C, s0, dtype="f32"):
    jdt = DT[dtype][0]
    return (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jdt), jnp.asarray(C, jdt),
            None if s0 is None else jnp.asarray(s0))


def _close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk,state", [
    (1, 128, 2, 16, 8, 32, False),
    (2, 256, 4, 32, 16, 64, True),
    (1, 64, 1, 8, 4, 64, False),      # single chunk
    (2, 100, 3, 16, 8, 32, True),     # ragged: padded with dt = 0
])
def test_ssd_matches_pallas(b, l, h, p, n, chunk, state, dtype):
    args = _inputs(b, l, h, p, n, seed=l + h, dtype=dtype, state=state)
    *ta, ts = _torch(*args, dtype)
    *ja, js = _jax(*args, dtype)
    ty, tf = ops.ssd(*ta, chunk, ts)
    jy, jf = jax_ssd_ops.ssd(*ja, chunk, js, impl="pallas", interpret=True)
    assert ty.dtype == DT[dtype][1] and tuple(ty.shape) == (b, l, h, p)
    assert tf.dtype == torch.float32 and tuple(tf.shape) == (b, h, p, n)
    _close(ty, jy, TOL[dtype])
    _close(tf, jf, TOL[dtype])


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_equals_sequential(chunk):
    args = _inputs(1, 64, 2, 8, 4, seed=chunk, state=True)
    *ta, ts = _torch(*args)
    yc, sc = ref.ssd_ref(*ta, chunk, ts)
    ys, ss = ref.ssd_sequential(*ta, ts)
    _close(yc, ys, 1e-3)
    _close(sc, ss, 1e-3)
    *ja, js = _jax(*args)
    jy, jst = jax_ssd_ref.ssd_sequential(*ja, js)
    _close(ys, jy, 1e-5)
    _close(ss, jst, 1e-5)


def test_decode_step_matches_jax():
    x, dt, A, B, C, s0 = _inputs(2, 1, 3, 8, 4, seed=9, state=True)
    ty, ts = ops.ssd_decode_step(torch.from_numpy(s0), torch.from_numpy(x[:, 0]),
                                 torch.from_numpy(dt[:, 0]), torch.from_numpy(A),
                                 torch.from_numpy(B[:, 0]),
                                 torch.from_numpy(C[:, 0]))
    jy, js = jax_ssd_ref.ssd_decode_step_ref(
        jnp.asarray(s0), jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
        jnp.asarray(A), jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def _split3(v):
    """v = hi + mid + lo, each a bf16 value (held in float32)."""
    hi = v.bfloat16().float()
    mid = (v - hi).bfloat16().float()
    return hi, mid, (v - hi - mid).bfloat16().float()


def test_kernel_precision_choice_beats_plain_float32():
    """The CUDA kernel's bf16 path for y_diag, emulated: cs as an f64
    cumsum, L = 2^f32((cs_i - cs_j) log2(e)) where j <= i, S = C B^T and
    P' = S o L o dt_j in f32 (dt folded into P's columns, so x stays exact
    in bf16), P' split into three bf16 parts and y_diag summed from the
    three products with x, each exact in f32 and summed in f32. At the
    full-width chunk (q 256, n 128, p 64) and the model's decays (dt =
    softplus(normal), A = -exp(0.2 normal): cs falls below -100), its mean
    error against float64 is no larger than the plain float32 version's
    (f32 cumsum): 6.5e-7 against 1.3e-5 on these inputs. Two parts (about
    16 bits) measured 1.6e-5 here, which is why the kernel takes three."""
    x, dt, A, B, C, _ = _inputs(1, 256, 2, 64, 128, seed=5, dtype="bf16")
    q = 256
    xc, dtc, A, Bc, Cc = (torch.from_numpy(a) for a in (x, dt, A, B, C))
    lower = torch.ones(q, q, dtype=torch.bool).tril()
    cs = torch.cumsum(dtc[0].double() * A.double(), 0).T     # (h, q) f64
    diff = cs[:, :, None] - cs[:, None, :]
    L64 = torch.exp(diff.masked_fill(~lower, float("-inf")))
    exact = torch.einsum("hij,jhp->ihp", (Cc[0].double() @ Bc[0].double().T)
                         * L64, xc[0].double() * dtc[0].double()[..., None])

    L = torch.exp2((diff * math.log2(math.e)).float()).masked_fill(~lower,
                                                                   0.0)
    P = (Cc[0] @ Bc[0].T) * L * dtc[0].T[:, None, :]         # (h, i, j)
    kernel = sum(torch.einsum("hij,jhp->ihp", part, xc[0])
                 for part in reversed(_split3(P)))
    plain = ref.ssd_chunk_terms(xc.reshape(1, 1, q, 2, 64),
                                dtc.reshape(1, 1, q, 2), A,
                                Bc.reshape(1, 1, q, 128),
                                Cc.reshape(1, 1, q, 128))[0][0, 0]
    assert float(cs.min()) < -100                            # strong decays
    err_kernel = float((kernel.double() - exact).abs().mean())
    err_plain = float((plain.double() - exact).abs().mean())
    assert err_kernel <= err_plain, (err_kernel, err_plain)


def test_wrapper_checks_and_dispatch():
    *ta, ts = _torch(*_inputs(1, 32, 2, 8, 4, state=True))
    before = ops.ssd.launches
    ops.ssd(*ta, 16, ts, impl="plain")
    ops.ssd(*ta, 16, ts)                        # auto: plain on the CPU
    assert ops.ssd.launches == before           # no kernel ran
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.ssd(*ta, 16, ts, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd(*ta, 16, ts, impl="pallas")
    x, dt, A, B, C = ta
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd(x, dt[:, :8], A, B, C, 16)
    with pytest.raises(ValueError, match="initial_state must be"):
        ops.ssd(x, dt, A, B, C, 16, ts[:, :1])
    # the kernel takes whole chunks only (the JAX kernel asserts)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.chunk_terms_kernel(x, dt, A, B, C, 12)


def _block_params(cfg, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for k, s in ssm.ssm_specs(cfg, torch.float32).items():
        if s.init == "normal":
            p[k] = (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                    ).astype(np.float32)
        else:
            p[k] = (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
    return p


def test_ssm_block_and_decode_step_match_jax():
    cfg = get_arch("mamba2-780m").reduced()
    jcfg = jax_arch("mamba2-780m").reduced()
    p = _block_params(cfg, 1)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    _close(ssm.ssm_apply(tp, torch.from_numpy(u), cfg),
           jax.jit(jssm.ssm_apply, static_argnums=2)(jp, jnp.asarray(u), jcfg),
           1e-5)
    specs = ssm.ssm_cache_specs(cfg, 2, torch.float32)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in specs.items()}
    ty, tc = ssm.ssm_decode_step(tp, torch.from_numpy(u[:, :1]), cfg,
                                 {k: torch.from_numpy(v)
                                  for k, v in cache.items()})
    jy, jc = jssm.ssm_decode_step(jp, jnp.asarray(u[:, :1]), jcfg,
                                  {k: jnp.asarray(v) for k, v in cache.items()})
    _close(ty, jy, 1e-5)
    for k in cache:
        _close(tc[k], jc[k], 1e-5)


def test_prefill_state_continues_the_sequence():
    """ssm_prefill's state, fed to the decode step, gives the full block's
    next output, also for prompts shorter than the conv's k - 1 inputs."""
    cfg = get_arch("mamba2-780m").reduced()
    tp = {k: torch.from_numpy(v) for k, v in _block_params(cfg, 3).items()}
    u = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    full = ssm.ssm_apply(tp, u, cfg)
    for s in (1, 2, 33):                 # 33: a chunk of 32 and a ragged one
        _, state = ssm.ssm_prefill(tp, u[:, :s], cfg)
        y, _ = ssm.ssm_decode_step(tp, u[:, s:s + 1], cfg, state)
        _close(y, full[:, s:s + 1], 1e-4)

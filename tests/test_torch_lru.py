"""The port's gated linear recurrence (``kernels/lru_scan``) and RG-LRU
block (``models/rglru.py``) against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages. The
port's plain version is held against ``lru_scan_pallas`` in interpret mode
and against the JAX oracles (``lru_scan_ref``, ``lru_scan_sequential``) at
1e-5, the JAX suite's tolerance for its kernel (``tests/test_kernels.py``);
bf16 outputs at one bf16 ulp of relative error (8e-3), since the two
frameworks round the float32 carry to bf16 at the same place but may sit on
either side of a rounding boundary. The blocks are compared in float32 at
1e-5.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import f32

from repro.config.registry import get_arch as jax_arch
from repro.kernels.lru_scan import ref as jax_lru_ref
from repro.models import rglru as jrglru
from repro_torch.config.registry import get_arch
from repro_torch.kernels.lru_scan import ops, ref
from repro_torch.models import rglru

# the package re-exports the function under the kernel module's name
jax_lru_kernel = importlib.import_module("repro.kernels.lru_scan.lru_scan")

TOL = {"f32": 1e-5, "bf16": 8e-3}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, l, w, seed=0, dtype="f32", h0=False):
    """a in (0.5, 0.99) (the RG-LRU's decays lie in (0, 1)), b normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99, (b, l, w)).astype(np.float32)
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    h = rng.standard_normal((b, w)).astype(np.float32) if h0 else None
    # bf16 inputs are rounded once, and both packages get the rounded values
    x = np.array(jnp.asarray(x, DT[dtype][0]).astype(jnp.float32))
    return a, x, h


def _torch(a, x, h, dtype):
    tdt = DT[dtype][1]
    return (torch.from_numpy(a), torch.from_numpy(x).to(tdt),
            None if h is None else torch.from_numpy(h))


def _jax(a, x, h, dtype):
    jdt = DT[dtype][0]
    return (jnp.asarray(a), jnp.asarray(x, jdt),
            None if h is None else jnp.asarray(h))


def _close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_and_the_jax_oracles(dtype, h0):
    a, x, h = _inputs(2, 128, 32, seed=1, dtype=dtype, h0=h0)
    th, tl = ops.lru_scan(*_torch(a, x, h, dtype))
    assert th.dtype == DT[dtype][1] and tl.dtype == torch.float32
    ja, jx, jh = _jax(a, x, h, dtype)
    tol = TOL[dtype]
    ph, pl = jax_lru_kernel.lru_scan_pallas(ja, jx, jh, interpret=True)
    _close(th, ph, tol)
    _close(tl, pl, 1e-5)               # h_last is f32 on both sides
    sh, sl = jax_lru_ref.lru_scan_sequential(ja, jx, jh)
    _close(th, sh, tol)
    _close(tl, sl, 1e-5)
    if dtype == "f32":   # the JAX oracle folds h0 in b's dtype: f32 only
        rh, rl = jax_lru_ref.lru_scan_ref(ja, jx, jh)
        _close(th, rh, tol)
        _close(tl, rl, 1e-5)


@pytest.mark.parametrize("l", [1, 37, 300])
def test_ragged_lengths_match_the_sequential_oracle(l):
    """Any length: the Pallas kernel raises unless min(256, l) divides l
    (300 here), the port does not."""
    a, x, h = _inputs(2, l, 24, seed=l, h0=True)
    th, tl = ops.lru_scan(*_torch(a, x, h, "f32"))
    sh, sl = jax_lru_ref.lru_scan_sequential(*_jax(a, x, h, "f32"))
    _close(th, sh, 1e-5)
    _close(tl, sl, 1e-5)
    ph, pl = ref.lru_scan_sequential(*_torch(a, x, h, "f32"))
    _close(th, ph, 1e-5)
    _close(tl, pl, 1e-5)
    if l % min(256, l):
        with pytest.raises(ValueError, match="not divisible"):
            jax_lru_kernel.lru_scan_pallas(*_jax(a, x, h, "f32"))


def test_wrapper_checks_and_dispatch():
    a, x, h = _torch(*_inputs(1, 8, 4, h0=True), "f32")
    before = ops.lru_scan.launches
    ops.lru_scan(a, x, h, impl="plain")
    ops.lru_scan(a, x, h)                       # auto: plain on the CPU
    assert ops.lru_scan.launches == before      # no kernel ran
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.lru_scan(a, x, h, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.lru_scan(a, x, h, impl="pallas")
    with pytest.raises(ValueError, match="one shape"):
        ops.lru_scan(a, x[:, :4])
    with pytest.raises(ValueError, match="h0 must be"):
        ops.lru_scan(a, x, h[:, :2])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.lru_scan(a.double(), x)


def _block_params(cfg, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for k, s in rglru.rglru_specs(cfg, torch.float32).items():
        if s.init == "normal":
            p[k] = (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                    ).astype(np.float32)
        else:   # biases and the decay parameter: small random values
            p[k] = (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
    return p


def test_rglru_block_and_decode_step_match_jax():
    cfg = get_arch("recurrentgemma-2b").reduced()
    jcfg = jax_arch("recurrentgemma-2b").reduced()
    p = _block_params(cfg, 3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    _close(rglru.rglru_block(tp, torch.from_numpy(x), cfg),
           jrglru.rglru_block(jp, jnp.asarray(x), jcfg), 1e-5)
    k = cfg.hybrid.conv_kernel
    cache = {"h": rng.standard_normal((2, 128)).astype(np.float32),
             "conv": rng.standard_normal((2, k - 1, 128)).astype(np.float32)}
    xt = x[:, :1]
    ty, tc = rglru.rglru_decode_step(
        tp, torch.from_numpy(xt), cfg,
        {n: torch.from_numpy(v) for n, v in cache.items()})
    jy, jc = jrglru.rglru_decode_step(
        jp, jnp.asarray(xt), jcfg, {n: jnp.asarray(v) for n, v in cache.items()})
    _close(ty, jy, 1e-5)
    for n in ("h", "conv"):
        _close(tc[n], jc[n], 1e-5)


def test_prefill_state_continues_the_sequence():
    """rglru_prefill's state, fed to the decode step, gives the full
    block's next output, also for prompts shorter than the conv's k - 1
    inputs (the conv state is left-padded with zeros)."""
    cfg = get_arch("recurrentgemma-2b").reduced()
    tp = {k: torch.from_numpy(v) for k, v in _block_params(cfg, 5).items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))
    full = rglru.rglru_block(tp, x, cfg)
    for s in (1, 2, 5):
        _, state = rglru.rglru_prefill(tp, x[:, :s], cfg)
        assert state["conv"].shape == (2, cfg.hybrid.conv_kernel - 1, 128)
        y, _ = rglru.rglru_decode_step(tp, x[:, s:s + 1], cfg, state)
        _close(y, full[:, s:s + 1], 1e-5)


# ------------------------------- the CUDA kernel's arithmetic, on the CPU
def _fma(a, h, b):
    """fmaf in float32: the product of two float32 values is exact in
    float64, the sum is rounded there and then to float32 (a double rounding
    that can differ from a true FMA in the last bit in rare cases)."""
    return (a.double() * h.double() + b.double()).float()


def _kernel_emulation(a, b, h0, steps, warps, max_cluster):
    """``csrc/lru_scan.cu`` in its order of operations: a thread's segment
    of `steps` steps composed from h = 0 into (prod a, h_end); a block's
    `warps` segments composed in order into its pair; a cluster of
    ceil(seq / (warps * steps)) blocks (at most `max_cluster`) along the
    sequence, each block's carry-in the span's carry through the pairs of
    the blocks before it; a thread's carry-in its block's through the
    segments before it; then the segment replayed from it. A longer sequence
    walks spans of cluster * warps * steps steps, the carry past one the
    carry into the next. Returns (h in b.dtype, h_last f32)."""
    bsz, l, w = a.shape
    af, bf = a.float(), b.float()
    per_block = warps * steps
    nc = min(max_cluster, -(-l // per_block))
    span = nc * per_block
    carry = h0.float() if h0 is not None else af.new_zeros((bsz, w))
    h = af.new_empty((bsz, l, w))
    for st in range(0, l, span):
        n = min(span, l - st)
        A, B = af.new_ones((bsz, span, w)), af.new_zeros((bsz, span, w))
        A[:, :n], B[:, :n] = af[:, st:st + n], bf[:, st:st + n]
        A = A.reshape(bsz, nc, warps, steps, w)
        B = B.reshape(bsz, nc, warps, steps, w)
        sp = A.new_ones((bsz, nc, warps, w))
        sh = A.new_zeros((bsz, nc, warps, w))
        for u in range(steps):                          # segments from 0
            sh = _fma(A[:, :, :, u], sh, B[:, :, :, u])
            sp = sp * A[:, :, :, u]
        bp, bh = A.new_ones((bsz, nc, w)), A.new_zeros((bsz, nc, w))
        for j in range(warps):                          # block pairs
            bh = _fma(sp[:, :, j], bh, sh[:, :, j])
            bp = bp * sp[:, :, j]
        hc, cta_in = carry, []
        for r in range(nc):                             # across the cluster
            cta_in.append(hc)
            hc = _fma(bp[:, r], hc, bh[:, r])
        carry = hc
        x, seg_in = torch.stack(cta_in, 1), []
        for j in range(warps):                          # within a block
            seg_in.append(x)
            x = _fma(sp[:, :, j], x, sh[:, :, j])
        hh, out = torch.stack(seg_in, 2), []
        for u in range(steps):                          # the replay
            hh = _fma(A[:, :, :, u], hh, B[:, :, :, u])
            out.append(hh)
        h[:, st:st + n] = torch.stack(out, 3).reshape(bsz, span, w)[:, :n]
    return h.to(b.dtype), h[:, -1].clone()


# (steps, warps, max cluster): the committed launch shape, and smaller ones
# whose spans a short sequence walks several times
KERNEL_SHAPES = [(16, 8, 8), (4, 4, 2), (8, 2, 4), (1, 1, 1)]


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("h0", [False, True])
def test_kernel_emulation_matches_pallas_and_the_oracle(shape, h0):
    a, x, h = _inputs(2, 512, 40, seed=11, h0=h0)
    eh, el = _kernel_emulation(*_torch(a, x, h, "f32"), *shape)
    ja, jx, jh = _jax(a, x, h, "f32")
    ph, pl = jax_lru_kernel.lru_scan_pallas(ja, jx, jh, interpret=True)
    _close(eh, ph, 1e-5)
    _close(el, pl, 1e-5)
    sh, sl = jax_lru_ref.lru_scan_sequential(ja, jx, jh)
    _close(eh, sh, 1e-5)
    _close(el, sl, 1e-5)


@pytest.mark.parametrize("l", [1, 31, 300, 2048, 5000])
@pytest.mark.parametrize("shape", KERNEL_SHAPES[:2])
def test_kernel_emulation_no_less_accurate_than_plain(l, shape):
    """Against a float64 recurrence, the kernel's order of operations is
    no further off than the plain version's (Hillis-Steele) rounds, at the
    mean and at the worst element; any length, including spans walked
    several times."""
    a, x, h = _inputs(1, l, 24, seed=l, h0=True)
    ta, tx, th = _torch(a, x, h, "f32")
    eh, el = _kernel_emulation(ta, tx, th, *shape)
    ph, _ = ref.lru_scan_ref(ta, tx, th)
    hd, exact = th.double(), []
    for t in range(l):
        hd = ta[:, t].double() * hd + tx[:, t].double()
        exact.append(hd)
    exact = torch.stack(exact, 1)
    de, dp = (eh.double() - exact).abs(), (ph.double() - exact).abs()
    assert float(de.mean()) <= float(dp.mean())
    assert float(de.max()) <= float(dp.max())
    _close(el, exact[:, -1], 1e-5)


def test_kernel_emulation_bf16_b_within_one_ulp():
    a, x, h = _inputs(2, 300, 40, seed=12, dtype="bf16", h0=True)
    eh, el = _kernel_emulation(*_torch(a, x, h, "bf16"), *KERNEL_SHAPES[1])
    assert eh.dtype == torch.bfloat16
    sh, sl = jax_lru_ref.lru_scan_sequential(*_jax(a, x, h, "bf16"))
    _close(eh, sh, TOL["bf16"])
    _close(el, sl, 1e-5)

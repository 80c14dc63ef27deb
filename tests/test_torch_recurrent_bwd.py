"""The backward of the port's two scans on the CPU: the plain backwards
(``lru_scan_vjp_ref``, ``ssd_chunk_terms_vjp_ref``, autograd of the plain
versions) against ``jax.vjp`` of the JAX package's ``ref`` functions on
the same numpy inputs and cotangents (float32: LRU at 1e-5, SSD at 1e-4,
the JAX suite's forward tolerances); the decompositions the CUDA backward
kernels compute (``lru_scan_bwd``: the same scan run from the end of the
sequence; ``ssd_chunk_bwd``: the f32 path's nine kernels' terms, and the
bf16 path's tensor-core decomposition with its split-bf16 products),
emulated in PyTorch and held against autograd, each cotangent on its own;
the bf16 path's precision choice against float64 at a full-width chunk;
and the reference's own fault: ``jax.grad`` through its Pallas scans
raises (``ROADMAP.md`` Queue 3), while its ``ref`` path differentiates.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lru_scan import ops as jax_lru_ops
from repro.kernels.lru_scan import ref as jax_lru_ref
from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan import ref as jax_ssd_ref
from repro_torch.kernels.lru_scan import ref as lru_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref


def _close(got, want, rtol):
    """Within `rtol` of the largest |want| (each gradient's own scale)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _lru_inputs(b, l, w, h0, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99, (b, l, w)).astype(np.float32)
    x, dh = (rng.standard_normal((b, l, w)).astype(np.float32)
             for _ in range(2))
    h, dl = ((rng.standard_normal((b, w)).astype(np.float32)
              for _ in range(2)) if h0 else (None, None))
    return a, x, h, dh, dl


def _t(v):
    return None if v is None else torch.from_numpy(v)


@pytest.mark.parametrize("b,l,w,h0", [(2, 64, 16, False), (3, 37, 20, True),
                                      (1, 1, 8, True), (2, 300, 5, True)])
def test_lru_plain_backward_matches_jax_vjp(b, l, w, h0):
    """da, db and dh0 of the port's plain backward against jax.vjp of
    repro's lru_scan_ref, cotangents of h and (with h0) h_last; ragged
    lengths and length 1."""
    a, x, h, dh, dl = _lru_inputs(b, l, w, h0, seed=l + w)
    got = lru_ref.lru_scan_vjp_ref(_t(a), _t(x), _t(h), _t(dh), _t(dl))
    if h0:
        _, vjp = jax.vjp(jax_lru_ref.lru_scan_ref, jnp.asarray(a),
                         jnp.asarray(x), jnp.asarray(h))
        want = vjp((jnp.asarray(dh), jnp.asarray(dl)))
    else:
        _, vjp = jax.vjp(lambda a_, x_: jax_lru_ref.lru_scan_ref(a_, x_),
                         jnp.asarray(a), jnp.asarray(x))
        want = vjp((jnp.asarray(dh), jnp.zeros((b, w), jnp.float32)))
        assert got[2] is None
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-5)


def _lru_bwd_emulation(a, h, h0, dh, dh_last):
    """lru_scan_bwd's arithmetic: the forward scan run from the end of the
    sequence (multiplier a_{t+1}, the identity at the last step; addend
    dh_t; carry in dh_last), then db = g, da = g h_{t-1}, dh0 = a_0 g_0."""
    b, l, w = a.shape
    a_rev = torch.cat([a[:, 1:], torch.ones((b, 1, w))], 1).flip(1)
    g, _ = lru_ref.lru_scan_sequential(a_rev, dh.flip(1), dh_last)
    g = g.flip(1)
    h_prev = torch.cat([(torch.zeros((b, 1, w)) if h0 is None
                         else h0[:, None]), h[:, :-1]], 1)
    return g * h_prev, g, a[:, 0] * g[:, 0]


@pytest.mark.parametrize("h0", [False, True])
def test_lru_bwd_is_the_scan_run_from_the_end(h0):
    """The backward kernel's identity: the reverse recurrence g_t = dh_t +
    a_{t+1} g_{t+1} (g_{L-1} = dh_{L-1} + dh_last) is the forward scan
    over the reversed sequence, and its outputs equal autograd's."""
    a, x, h, dh, dl = _lru_inputs(2, 50, 12, True, seed=3)
    a, x, dh = _t(a), _t(x), _t(dh)
    h0_ = _t(h) if h0 else None
    dl_ = _t(dl) if h0 else None
    hs, _ = lru_ref.lru_scan_sequential(a, x, h0_)
    got = _lru_bwd_emulation(a, hs, h0_, dh, dl_)
    want = lru_ref.lru_scan_vjp_ref(a, x, h0_, dh, dl_)
    for g, w_ in zip(got, want):
        if w_ is not None:
            _close(g, w_, 1e-5)


def _ssd_inputs(b, c, q, h, p, n, seed):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.log1p(np.exp(normal(b, c, q, h))).astype(np.float32)
    A = -np.exp(0.2 * normal(h)).astype(np.float32)
    return (normal(b, c, q, h, p), dt, A, normal(b, c, q, n),
            normal(b, c, q, n), normal(b, c, q, h, p), normal(b, c, h, p, n),
            normal(b, c, q, h))


@pytest.mark.parametrize("b,c,q,h,p,n", [(2, 3, 16, 3, 8, 5),
                                         (1, 2, 32, 4, 16, 16),
                                         (1, 1, 7, 2, 4, 3)])
def test_ssd_plain_backward_matches_jax_vjp(b, c, q, h, p, n):
    """dx, ddt, dA, dB and dC of ssd_chunk_terms_vjp_ref against jax.vjp
    of repro's ssd_chunk_terms, cotangents of y_diag, states and decay_in
    (decay_chunk's arrives through decay_in on the kernel path: zero
    here)."""
    x, dt, A, B, C, dy, dst, ddi = _ssd_inputs(b, c, q, h, p, n, seed=q + h)
    got = ssd_ref.ssd_chunk_terms_vjp_ref(*map(_t, (x, dt, A, B, C, dy,
                                                    dst, ddi)))
    _, vjp = jax.vjp(jax_ssd_ref.ssd_chunk_terms,
                     *map(jnp.asarray, (x, dt, A, B, C)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst),
                jnp.zeros((b, c, h), jnp.float32), jnp.asarray(ddi)))
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-4)


@pytest.mark.parametrize("l,chunk,state", [(40, 16, False), (64, 32, True)])
def test_ssd_gradients_match_jax_grad_of_ref(l, chunk, state):
    """The gradients of the port's ops.ssd (the plain path, a ragged
    length padded under autograd) against jax.grad of repro's
    ssd(impl="ref"), for a loss reading y and the final state."""
    rng = np.random.default_rng(l)
    b, h, p, n = 2, 3, 8, 4
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.2 * rng.standard_normal(h)).astype(np.float32)
    B, C = (rng.standard_normal((b, l, n)).astype(np.float32)
            for _ in range(2))
    s0 = (rng.standard_normal((b, h, p, n)).astype(np.float32) if state
          else None)
    wy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(*args):
        y, st = jax_ssd_ops.ssd(*args[:5], chunk, args[5], impl="ref")
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    jargs = [jnp.asarray(v) for v in (x, dt, A, B, C)] + [
        None if s0 is None else jnp.asarray(s0)]
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, dt, A, B, C)]
    y, st = ssd_ops.ssd(*leaves, chunk, _t(s0), impl="plain")
    loss = (y * _t(wy)).sum() + (st * _t(ws)).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w_ in zip(got, want):
        _close(g.detach(), w_, 1e-4)


def _ssd_bwd_emulation(x, dt, A, B, C, dy, dst_np, ddi):
    """ssd_chunk_bwd's decomposition for f32 inputs (csrc/ssd_scan.cu, the
    SIMT kernels 1-9) in PyTorch: f32 products, cs and the reverse cumsum
    in f64; dst_np in the kernel's (n, p) layout."""
    b, c, q, h, p = x.shape
    cs = torch.cumsum(dt.double() * A.double(), dim=2).permute(0, 1, 3, 2)
    lower = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.exp((cs[..., :, None] - cs[..., None, :]).float()
                  .masked_fill(~lower, float("-inf")))
    S = torch.einsum("bcin,bcjn->bcij", C, B)
    u = (x * dt[..., None]).permute(0, 1, 3, 2, 4)        # (b,c,h,q,p)
    dyh = dy.permute(0, 1, 3, 2, 4)
    dM = (dyh @ u.transpose(-1, -2)) * lower               # (b,c,h,i,j)
    M = S[:, :, None] * L
    dl = dM * M
    rows, cols = dl.sum(-1), dl.sum(-2)                    # 3. and 5.
    dS = (dM * L).sum(2)                                   # 3. and 4.
    w = torch.exp((cs[..., -1:] - cs).float())
    V = torch.einsum("bcjn,bchnp->bchjp", B, dst_np)
    du = M.transpose(-1, -2) @ dyh + w[..., None] * V      # 5.
    dw = (u * V).sum(-1)
    dC = dS @ B                                            # 4.
    dB = dS.transpose(-1, -2) @ C + torch.einsum(          # 6. and 7.
        "bchj,bchjp,bchnp->bcjn", w, u, dst_np)
    dth = dt.permute(0, 1, 3, 2)
    dx = (du * dth[..., None]).permute(0, 1, 3, 2, 4)
    ddtu = (du * x.permute(0, 1, 3, 2, 4)).sum(-1)
    dcs = (rows.double() - cols.double()                   # 8.
           + ddi.permute(0, 1, 3, 2).double() * torch.exp(cs.float()).double()
           - dw.double() * w.double())
    dcs[..., -1] += (dw * w).sum(-1).double()
    dA_k = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = (dA_k * A.double()[:, None] + ddtu.double()).float()
    dA = (dA_k * dth.double()).sum((0, 1, 3)).float()      # 8. and 9.
    return dx, ddt.permute(0, 1, 3, 2), dA, dB, dC


@pytest.mark.parametrize("which", ["y_diag", "states", "decay_in", "all"])
def test_ssd_bwd_decomposition_matches_autograd(which):
    """Each term of the backward kernel against autograd of the plain
    within-chunk terms, one cotangent at a time: y_diag's (dM, the segsum
    gradient through rowsum - colsum of dM o M, M^T dY, the head sums
    into dB and dC), the states' (V = dSt^T B, w_j and its gradient into
    cs_{q-1} and cs_j, dSt u into dB), decay_in's (exp(cs)), and all
    three; float32 at 1e-5 of each gradient's largest magnitude."""
    x, dt, A, B, C, dy, dst, ddi = map(_t, _ssd_inputs(2, 3, 16, 3, 8, 5,
                                                       seed=11))
    keep = {"y_diag": (1, 0, 0), "states": (0, 1, 0),
            "decay_in": (0, 0, 1), "all": (1, 1, 1)}[which]
    dy, dst, ddi = (t * k for t, k in zip((dy, dst, ddi), keep))
    want = ssd_ref.ssd_chunk_terms_vjp_ref(x, dt, A, B, C, dy, dst, ddi)
    got = _ssd_bwd_emulation(x, dt, A, B, C, dy, dst.transpose(-1, -2), ddi)
    for g, w_ in zip(got, want):
        if float(w_.abs().max()) > 0:
            _close(g, w_, 1e-5)
        else:
            assert float(g.abs().max()) == 0.0


def _split3(v):
    """v = hi + mid + lo, each part a bf16 (the kernels' split3)."""
    hi = v.bfloat16().float()
    mid = (v - hi).bfloat16().float()
    return hi, mid, (v - hi - mid).bfloat16().float()


# (part of A, part of B) of the products that make M^T dY in the bf16
# backward, smallest first: hh hm mh mm hl lh (0 = hi, 1 = mid, 2 = lo)
_DU_PARTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _parts_product(a, b, pairs):
    """a @ b from bf16 parts of both f32 operands, each product exact and
    summed in f32, in the order of `pairs`."""
    pa, pb = _split3(a), _split3(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for i, j in pairs:
        out = out + pa[i] @ pb[j]
    return out


def _exact_split(a, b):
    """a @ b where a is exact in bf16 and b (f32) is split in three parts:
    three products summed in f32, lo first."""
    return sum((a @ part for part in reversed(_split3(b))),
               torch.zeros(a.shape[:-1] + b.shape[-1:]))


def _ssd_bwd_tc_emulation(x, dt, A, B, C, dy, dst_np, ddi,
                          du_pairs=_DU_PARTS):
    """ssd_chunk_bwd's bf16 path (csrc/ssd_scan.cu, bwd_tc and the kernels
    around it) in PyTorch: every product as the tensor cores take it (bf16
    parts, f32 sums: S = C B^T exact; dM = dt_j (x_j . dY_i) with dY in
    three parts; M^T dY from parts of both, `du_pairs`; V = B dSt and the
    states' x_j dSt^T with dSt in three parts; dB and dC from the head sum
    of dM o L in three parts), L = 2^(f32 of (cs_i - cs_j) log2 e) from an
    f64 cs, rowsum's partials per row tile (64 rows j) and row group (16)
    and dC's per row tile added in order, cs and the reverse cumsum in
    f64. x, B, C hold bf16 values; dst_np in the kernel's (n, p) layout."""
    b, c, q, h, p = x.shape
    lower = torch.ones(q, q, dtype=torch.bool).tril()
    cs = torch.cumsum(dt.double() * A.double(), dim=2).permute(0, 1, 3, 2)
    L = torch.exp2(((cs[..., :, None] - cs[..., None, :]) * math.log2(math.e))
                   .float()).masked_fill(~lower, 0.0)       # (b,c,h,i,j)
    S = C @ B.transpose(-1, -2)                             # (b,c,i,j)
    xh, dyh = x.permute(0, 1, 3, 2, 4), dy.permute(0, 1, 3, 2, 4)
    dth = dt.permute(0, 1, 3, 2)                            # (b,c,h,q)
    dM = _exact_split(xh, dyh.transpose(-1, -2)).transpose(-1, -2)
    dM = dM * dth[..., None, :] * lower                     # (b,c,h,i,j)
    M = S[:, :, None] * L
    dl = dM * M
    pad = (-q) % 64
    parts = torch.nn.functional.pad(dl, (0, pad)).reshape(
        b, c, h, q, -1, 16).sum(-1)                         # tiles x groups
    rows = parts[..., 0]
    for k in range(1, parts.shape[-1]):
        rows = rows + parts[..., k]
    cols = dl.sum(-2)
    dS = (dM * L).sum(2)                                    # heads in order
    w = torch.exp2(((cs[..., -1:] - cs) * math.log2(math.e)).float())
    V = _exact_split(B[:, :, None], dst_np)                 # (b,c,h,q,p)
    du = _parts_product(M.transpose(-1, -2), dyh, du_pairs) + w[..., None] * V
    dw = (xh * dth[..., None] * V).sum(-1)
    states = ((w * dth)[..., None]
              * _exact_split(xh, dst_np.transpose(-1, -2))).sum(2)
    dB = states + sum(part.transpose(-1, -2) @ C
                      for part in reversed(_split3(dS)))
    dC = torch.zeros_like(C)
    for j0 in range(0, q, 64):                              # row tiles j
        dC = dC + sum(part[..., j0:j0 + 64] @ B[..., j0:j0 + 64, :]
                      for part in reversed(_split3(dS)))
    dx = (du * dth[..., None]).permute(0, 1, 3, 2, 4)
    ddtu = (du * xh).sum(-1)
    dcs = (rows.double() - cols.double()
           + ddi.permute(0, 1, 3, 2).double() * torch.exp(cs.float()).double()
           - dw.double() * w.double())
    dcs[..., -1] += (dw * w).sum(-1).double()
    dA_k = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = (dA_k * A.double()[:, None] + ddtu.double()).float()
    dA = (dA_k * dth.double()).sum((0, 1, 3)).float()
    return dx, ddt.permute(0, 1, 3, 2), dA, dB, dC


def _bf16_values(*ts):
    return [t.bfloat16().float() for t in ts]


@pytest.mark.parametrize("which", ["y_diag", "states", "decay_in", "all"])
def test_ssd_bwd_tc_decomposition_matches_autograd(which):
    """The bf16 path's decomposition (row tiles of 64 rows j, split parts)
    against autograd of the plain within-chunk terms on the same bf16
    values, one cotangent at a time and all three, with a chunk that is
    not a multiple of the row tile: float32 at 1e-5 of each gradient's
    largest magnitude."""
    x, dt, A, B, C, dy, dst, ddi = map(_t, _ssd_inputs(2, 2, 80, 3, 16, 24,
                                                       seed=12))
    x, B, C = _bf16_values(x, B, C)
    keep = {"y_diag": (1, 0, 0), "states": (0, 1, 0),
            "decay_in": (0, 0, 1), "all": (1, 1, 1)}[which]
    dy, dst, ddi = (t * k for t, k in zip((dy, dst, ddi), keep))
    want = ssd_ref.ssd_chunk_terms_vjp_ref(x, dt, A, B, C, dy, dst, ddi)
    got = _ssd_bwd_tc_emulation(x, dt, A, B, C, dy, dst.transpose(-1, -2),
                                ddi)
    for g, w_ in zip(got, want):
        if float(w_.abs().max()) > 0:
            _close(g, w_, 1e-5)
        else:
            assert float(g.abs().max()) == 0.0


def _chunk_terms64(xc, dtc, A, Bc, Cc):
    """ref.ssd_chunk_terms's y_diag, states and decay_in in float64 (the
    plain version computes in float32 whatever its inputs)."""
    dA = dtc * A
    L = torch.exp(ssd_ref.segsum(dA.transpose(-1, -2)))
    att = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    xdt = xc * dtc[..., None]
    y = torch.matmul(att[:, :, None] * L,
                     xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    cs = torch.cumsum(dA, dim=2)
    states = torch.einsum("bckn,bckhp->bchpn", Bc,
                          xdt * torch.exp(cs[:, :, -1:] - cs)[..., None])
    return y, states, torch.exp(cs)


def test_ssd_bwd_kernel_precision_choice_beats_plain_float32():
    """The bf16 backward's products, emulated (_ssd_bwd_tc_emulation) at
    one full-width chunk of Mamba-2 780M (q 256, n 128, p 64, two heads,
    the model's decays: dt = softplus(normal), A = -exp(0.2 normal); cs
    falls to -213): each of dx, ddt, dA, dB and dC has a mean error
    against float64 no larger than the plain float32 backward's (autograd
    of ssd_chunk_terms). On these inputs: plain 1.16e-5, 2.86e-4, 3.23e-2,
    1.38e-5, 1.40e-5; the kernel's 8.9e-7, 4.9e-5, 7.0e-3, 9.1e-7,
    6.5e-7. M^T dY has no exact operand; rejected for it: the products
    hh hm mh of the parts (dx 3.02e-5, ddt 3.75e-4, both above plain),
    hh hm mh mm (dx 2.40e-5) and any five of the six (dx 1.63e-5 to
    1.89e-5); 3xTF32 (big and small TF32 parts, bb + bs + sb) passes (dx
    1.1e-6, ddt 5.0e-5) but costs what the six bf16 products cost on the
    tensor cores (m16n8k8 at half the bf16 rate) and could not use the
    bf16 parts of dY that the kernel splits once for dM."""
    q, h, p, n = 256, 2, 64, 128
    x, dt, A, B, C, dy, dst, ddi = map(_t, _ssd_inputs(1, 1, q, h, p, n,
                                                       seed=5))
    x, B, C = _bf16_values(x, B, C)
    cots = (dy, dst, ddi)
    leaves = [t.double().requires_grad_(True) for t in (x, dt, A, B, C)]
    exact = torch.autograd.grad(_chunk_terms64(*leaves), leaves,
                                [t.double() for t in cots])
    plain = ssd_ref.ssd_chunk_terms_vjp_ref(x, dt, A, B, C, *cots)
    assert float(torch.cumsum(dt.double() * A.double(), 2).min()) < -100

    def mean_errs(got):
        return [float((g.double() - e).abs().mean())
                for g, e in zip(got, exact)]

    kernel = _ssd_bwd_tc_emulation(x, dt, A, B, C, dy,
                                   dst.transpose(-1, -2), ddi)
    rejected = _ssd_bwd_tc_emulation(x, dt, A, B, C, dy,
                                     dst.transpose(-1, -2), ddi,
                                     du_pairs=((1, 0), (0, 1), (0, 0)))
    err_k, err_p, err_r = map(mean_errs, (kernel, plain, rejected))
    for name, k_, p_ in zip(("dx", "ddt", "dA", "dB", "dC"), err_k, err_p):
        assert k_ <= p_, (name, k_, p_)
    assert err_r[0] > err_p[0]   # three products of M^T dY lose dx


def test_jax_pallas_scans_cannot_be_differentiated():
    """A fault of the reference (ROADMAP.md Queue 3): jax.grad through the
    Pallas scans (interpret mode, as on the CPU) raises, so on a TPU,
    where impl="auto" picks Pallas, the JAX Trainer cannot train the ssm
    or hybrid families; the ref path differentiates."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.uniform(0.5, 0.99, (1, 16, 8)).astype(np.float32))
    xb = jnp.asarray(rng.standard_normal((1, 16, 8)).astype(np.float32))

    def lru_loss(impl):
        return lambda a_, b_: jnp.sum(jax_lru_ops.lru_scan(
            a_, b_, impl=impl, **({"interpret": True} if impl == "pallas"
                                  else {}))[0])

    assert np.isfinite(np.asarray(jax.grad(lru_loss("ref"))(a, xb))).all()
    with pytest.raises(AssertionError):
        jax.grad(lru_loss("pallas"))(a, xb)

    x = jnp.asarray(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    dt = jnp.full((1, 16, 2), 0.5, jnp.float32)
    A = -jnp.ones((2,), jnp.float32)
    B = jnp.asarray(rng.standard_normal((1, 16, 4)).astype(np.float32))

    def ssd_loss(impl):
        return lambda x_: jnp.sum(jax_ssd_ops.ssd(
            x_, dt, A, B, B, 8, impl=impl,
            **({"interpret": True} if impl == "pallas" else {}))[0])

    assert np.isfinite(np.asarray(jax.grad(ssd_loss("ref"))(x))).all()
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(ssd_loss("pallas"))(x)

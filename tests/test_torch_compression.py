"""The port's wire codecs and hierarchical all-reduce on one rank against
the JAX package, mirroring ``tests/test_optim.py``'s compression cases.

Inputs are made from a seed with numpy and handed to both packages. The
port divides by the scale; XLA may multiply by its reciprocal, so an int8
``q`` may differ by one at a rounding tie: the tests bound the difference
by one quantum (and count it), and hold bf16 and fp8 casts bit for bit.
The multi-rank cases (the scale shared over an axis, the staged sum) run on
gloo ranks in ``tests/test_torch_dist.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch.core.reduction import hierarchical_allreduce
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import compression as tc

SCALES = [1e-3, 0.1, 1.0, 37.0, 1e3]


def _x(scale, seed=0, n=256):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


@pytest.mark.parametrize("scale", SCALES)
def test_int8_matches_jax_within_one_quantum(scale):
    x = _x(scale)
    got = tc.int8_compress(torch.from_numpy(x))
    want = jc.int8_compress(jnp.asarray(x))
    assert got["q"].dtype == torch.int16 and got["scale"].dim() == 0
    np.testing.assert_allclose(float(got["scale"]), float(want["scale"]),
                               rtol=1e-7)
    dq = np.abs(got["q"].numpy().astype(np.int32)
                - np.asarray(want["q"]).astype(np.int32))
    assert dq.max() <= 1 and (dq > 0).mean() < 0.01
    y = tc.int8_decompress(got).numpy()
    # quantization step = max|x| / 127 (the JAX suite's bound)
    assert np.abs(x - y).max() <= np.abs(x).max() / 127 + 1e-6


@pytest.mark.parametrize("scale", SCALES)
def test_bf16_matches_jax_and_roundtrip_relative_error(scale):
    x = _x(scale)
    p = tc.bf16_compress(torch.from_numpy(x))
    assert p["q"].dtype == torch.bfloat16
    want = np.asarray(jc.bf16_compress(jnp.asarray(x))["q"].astype(
        jnp.float32))
    y = tc.bf16_decompress(p)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), want)
    err = np.abs(x - y.numpy())
    np.testing.assert_array_less(err, np.abs(x) * 2.0**-8 + 1e-38)


@pytest.mark.parametrize("scale", SCALES)
def test_fp8_matches_jax_and_roundtrip_bounded_error(scale):
    x = _x(scale)
    p = tc.fp8_compress(torch.from_numpy(x))
    assert p["q"].dtype == torch.float8_e4m3fn
    jp = jc.fp8_compress(jnp.asarray(x))
    np.testing.assert_allclose(float(p["scale"]), float(jp["scale"]),
                               rtol=1e-7)
    np.testing.assert_array_equal(p["q"].float().numpy(),
                                  np.asarray(jp["q"].astype(jnp.float32)))
    y = tc.fp8_decompress(p).numpy()
    s = float(p["scale"])
    bound = np.maximum(np.abs(x) * 2.0**-3, s * 2.0**-9) + 1e-38
    assert (np.abs(x - y) <= bound).all()


def test_fp8_scale_saturates_at_amax():
    x = torch.tensor([-7.0, 0.5, 3.5])
    y = tc.fp8_decompress(tc.fp8_compress(x))
    np.testing.assert_allclose(float(y[0]), -7.0, rtol=1e-6)
    assert tc._FP8_MAX == 448.0


def test_wire_codec_registry():
    assert sorted(tc.WIRE_CODECS) == sorted(jc.WIRE_CODECS)
    for kind in ("bf16", "fp8", "int8"):
        compress, decompress = tc.wire_codec(kind)
        x = torch.from_numpy(_x(1.0, seed=2, n=32))
        y = decompress(compress(x))
        assert y.shape == x.shape and y.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown wire codec"):
        tc.wire_codec("fp4")


@pytest.mark.parametrize("kind,seed", [("int8", 1), ("fp8", 3)])
def test_error_feedback_converges_and_tracks_jax(kind, seed):
    """EF carries the residual, so the mean of the sent updates converges
    to the gradient (the JAX suite's tolerance); step by step the port's
    sent values stay within one quantum of the JAX package's."""
    g = _x(0.1, seed=seed, n=64)
    compress, decompress = tc.wire_codec(kind)
    jcomp, jdecomp = jc.WIRE_CODECS[kind]
    err, jerr = torch.zeros(64), jnp.zeros(64)
    sent = []
    for _ in range(50):
        payload, err = tc.ef_compress_update(torch.from_numpy(g), err,
                                             compress=compress,
                                             decompress=decompress)
        jpayload, jerr = jc.ef_compress_update(jnp.asarray(g), jerr,
                                               compress=jcomp,
                                               decompress=jdecomp)
        s = decompress(payload).numpy()
        quantum = float(payload["scale"]) * (1.0 if kind == "int8"
                                             else 32.0)
        assert np.abs(s - np.asarray(jdecomp(jpayload))).max() <= quantum
        sent.append(s)
    np.testing.assert_allclose(np.mean(sent, axis=0), g, rtol=0.08,
                               atol=0.02)


def test_codecs_on_one_rank_need_the_mesh_to_share_a_scale():
    mesh = make_mesh((1,), ("pod",), "cpu")
    x = torch.from_numpy(_x(3.0))
    with pytest.raises(ValueError, match="needs the mesh"):
        tc.int8_compress(x, "pod")
    a, b = tc.int8_compress(x, "pod", mesh), tc.int8_compress(x)
    assert torch.equal(a["q"], b["q"]) and torch.equal(a["scale"],
                                                       b["scale"])
    comp, decomp = tc.make_crosspod_codec(mesh, "pod")
    assert torch.equal(decomp(comp(x)), tc.int8_decompress(b))


@pytest.mark.parametrize("shape,dim", [((16, 8), 0), ((5, 8), 0),
                                       ((4, 6), 1)])
def test_hierarchical_allreduce_on_one_rank_is_identity(shape, dim):
    mesh = make_mesh((1, 1), ("pod", "data"), "cpu")
    x = torch.from_numpy(_x(1.0, n=int(np.prod(shape))).reshape(shape))
    assert torch.equal(hierarchical_allreduce(x, mesh, "data", "pod", dim), x)
    comp, decomp = tc.make_crosspod_codec(mesh, "pod")
    got = hierarchical_allreduce(x, mesh, "data", "pod", dim, comp, decomp)
    assert torch.equal(got, tc.int8_decompress(tc.int8_compress(x)))

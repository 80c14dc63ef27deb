"""Shared fixtures of the port-vs-JAX model tests: one parameter tree, made
with numpy from a seed, loaded into both packages.

The JAX package's own init folds Python's ``hash`` of each leaf's path into
its key, and string hashes are salted per process, so its parameters differ
from run to run. These tests draw every leaf with numpy instead (the same
initializers: zeros, ones, or normal times 1/sqrt(fan_in)), so each run sees
the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config.registry import get_arch as jax_arch
from repro.models.layers import ParamSpec as JaxSpec
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro_torch.config.registry import get_arch
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import ModelOptions, build_model

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def numpy_params(jax_model, seed: int = 0):
    """The JAX model's parameter tree, drawn with numpy (numpy leaves in the
    spec dtypes)."""
    rng = np.random.default_rng(seed)

    def draw(spec: JaxSpec):
        if spec.init == "zeros":
            a = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            a = np.ones(spec.shape, np.float32)
        else:
            fan_in = spec.shape[0] if len(spec.shape) > 1 else max(
                spec.shape[-1], 1)
            scale = spec.scale if spec.scale is not None else 1 / math.sqrt(
                fan_in)
            a = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(a, spec.dtype))

    return jax.tree.map(draw, jax_model.param_specs(),
                        is_leaf=lambda s: isinstance(s, JaxSpec))


def both_models(arch: str, dtype: str = "f32", attn_impl: str = "flash",
                scan: bool = True, seed: int = 0, **replace):
    """(JAX model, its params, port model, its params) for the reduced
    config of `arch` (fields overridden by `replace`), on the CPU."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    jm = jax_build(jcfg, JaxOptions(attn_impl=attn_impl, dtype=jdt,
                                    scan_layers=scan))
    tree = numpy_params(jm, seed)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(cfg, ModelOptions(attn_impl=attn_impl, dtype=tdt,
                                       scan_layers=scan))
    return jm, jp, tm, params_from_jax(tree, cfg, tm.opt, "cpu")


def jitted(jax_model):
    """(prefill, decode_step) of a JAX model, jitted as its server does."""
    return (jax.jit(jax_model.prefill, static_argnames="max_len"),
            jax.jit(jax_model.decode_step))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def frontend_stub(cfg, b: int, seed: int = 0):
    """(key, numpy float32 array) of the family's stub frontend input:
    Whisper's frames (b, enc_seq, d_model), LLaVA's patches (b, patches,
    d_model), normal times 0.02 from `seed`; None for other families."""
    if cfg.family == "encdec":
        key, n = "frames", cfg.encdec.enc_seq
    elif cfg.family == "vlm":
        key, n = "patches", cfg.num_vision_patches
    else:
        return None
    rng = np.random.default_rng(seed)
    return key, (rng.standard_normal((b, n, cfg.d_model)) * 0.02).astype(
        np.float32)


def both_batches(cfg, tokens, dtype: str = "f32", targets=None,
                 stub_dtype=None, seed: int = 0):
    """The same batch for both packages: `tokens` (and `targets`), with the
    family's stub frontend input in `stub_dtype` (default `dtype`)."""
    jdt, tdt = DTYPES[stub_dtype or dtype]
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"tokens": torch.from_numpy(np.asarray(tokens, np.int64))}
    if targets is not None:
        jb["targets"] = jnp.asarray(targets, jnp.int32)
        tb["targets"] = torch.from_numpy(np.asarray(targets, np.int64))
    stub = frontend_stub(cfg, np.shape(tokens)[0], seed)
    if stub is not None:
        key, a = stub
        jb[key] = jnp.asarray(a, jdt)
        tb[key] = torch.from_numpy(a).to(tdt)
    return jb, tb

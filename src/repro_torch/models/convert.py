"""Parameters of the JAX package, converted for the port.

:func:`params_from_jax` takes the JAX model's parameter tree as nested
dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``),
scanned (stacked layers) or unrolled (a list of layers), and returns the
port's :class:`~repro_torch.models.layers.ParamTree` in the layout that
``options.scan_layers`` asks for (a stack that is never uniform,
RecurrentGemma's or the encoder-decoder's, is unrolled in both; Whisper's
encoder is a list of layers in both, beside ``enc_norm``/``enc_norm_b``,
the LayerNorm biases ``*_b`` and ``audio_proj``; the VLM has
``vision_proj``). The layouts are the same tree by construction, so the
conversion is a check and a copy: a missing or extra leaf, or a leaf of
the wrong shape, raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.layers import ParamTree, leaf_paths, rebuild
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.models.transformer import uniform_stack


def _relayout(layers: Any, scan: bool) -> Any:
    """Stack an unrolled list of layers, or unstack a scanned tree."""
    if scan and isinstance(layers, (list, tuple)):
        if not layers:
            return layers
        flat = [leaf_paths(layer) for layer in layers]
        keys = set(flat[0])
        if any(set(f) != keys for f in flat):
            raise ValueError("params_from_jax: the unrolled layers differ in "
                             "their leaves")
        stacked = {p: np.stack([np.asarray(f[p]) for f in flat])
                   for p in keys}
        return rebuild(layers[0], stacked)
    if not scan and isinstance(layers, dict):
        flat = leaf_paths(layers)
        n = {np.shape(v)[0] for v in flat.values()}
        if len(n) != 1:
            raise ValueError(f"params_from_jax: stacked layer leaves disagree "
                             f"on the layer count: {sorted(n)}")
        return [rebuild(layers, {p: np.asarray(v)[i] for p, v in flat.items()})
                for i in range(n.pop())]
    return layers


def _to_torch(arr, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind != "f" or a.dtype.itemsize < 4:
        a = a.astype(np.float32)  # bf16 (ml_dtypes) and f16 go through f32
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                        dtype=dtype)


def params_from_jax(tree: dict, cfg: ModelConfig,
                    options: Optional[ModelOptions] = None,
                    device="cuda") -> ParamTree:
    """The port's parameters from the JAX package's (numpy leaves)."""
    device = resolve_device(device)
    model = build_model(cfg, options)
    specs = model.param_specs()
    if not isinstance(tree, dict) or "layers" not in tree:
        raise ValueError("params_from_jax: expected the JAX model's params "
                         "dict (with 'layers')")
    # a stack that is not uniform (hybrid) is unrolled in either layout
    scan = model.opt.scan_layers and uniform_stack(cfg)
    tree = dict(tree, layers=_relayout(tree["layers"], scan))
    want, got = leaf_paths(specs), leaf_paths(tree)
    missing = sorted(map(str, set(want) - set(got)))
    extra = sorted(map(str, set(got) - set(want)))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing leaves {missing}, "
                         f"unexpected leaves {extra}")
    leaves = {}
    for path, spec in want.items():
        shape = tuple(np.shape(got[path]))
        if shape != tuple(spec.shape):
            raise ValueError(f"params_from_jax: leaf {path} has shape {shape}, "
                             f"expected {tuple(spec.shape)}")
        leaves[path] = _to_torch(got[path], spec.dtype, device)
    return ParamTree(rebuild(specs, leaves))

"""Operations and bytes of the Mamba-2 family (``reference/ssm.py``'s
model), as functions of the configuration and the shapes. They count the
work the step needs, whatever computes it: a product of (m, k) by (k, n)
is 2 m k n operations, the SSD's within-chunk products only over the
causal pairs (i >= j) of a chunk, every input byte read once and every
output byte written once; a recompute counts nothing.
"""
from __future__ import annotations

from typing import Dict, Tuple

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _dims(cfg: Dict) -> Tuple[int, ...]:
    s, d = cfg["ssm"], cfg["d_model"]
    di = s["expand"] * d
    return (d, di, di // s["head_dim"], s["head_dim"], s["state_dim"],
            s["conv_kernel"], s["chunk_size"])


def ssd_chunk_flops(cfg: Dict, rows: int, seq: int) -> float:
    """The within-chunk terms of one layer (what the SSD kernel computes):
    C B^T over the causal pairs, its product with x dt for every head,
    and the chunk states."""
    _, _, h, p, n, _, q = _dims(cfg)
    chunks = rows * (seq // q)
    pairs = q * (q + 1) / 2
    return chunks * (2 * n * pairs + 2 * p * h * pairs + 2 * q * n * p * h)


def layer_forward_flops(cfg: Dict, rows: int, seq: int) -> float:
    """One layer's forward: the five input projections, the convolution,
    the SSD (within-chunk terms and the off-diagonal term C h) and the
    output projection."""
    d, di, h, p, n, k, q = _dims(cfg)
    tokens = rows * seq
    proj = 2 * tokens * (d * (2 * di + 2 * n + h) + di * d)
    conv = 2 * tokens * k * (di + 2 * n)
    off = 2 * tokens * n * p * h
    return proj + conv + ssd_chunk_flops(cfg, rows, seq) + off


def step_flops(cfg: Dict, rows: int, seq: int) -> float:
    """Model operations of one training step: the forward of every layer
    and of the head, and a backward of twice that."""
    fwd = (cfg["num_layers"] * layer_forward_flops(cfg, rows, seq)
           + 2 * rows * seq * cfg["d_model"] * cfg["vocab_size"])
    return 3 * fwd


def ssd_fwd_cost(cfg: Dict, rows: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one call of the SSD forward kernel on one
    layer: reads x, dt, A, B, C; writes the within-chunk output, the chunk
    states and the in-chunk decay, each float32."""
    _, _, h, p, n, _, q = _dims(cfg)
    e = DTYPE_BYTES[cfg["dtype"]]
    bl, chunks = rows * seq, rows * (seq // q)
    read = e * bl * h * p + 4 * bl * h + 4 * h + 2 * e * bl * n
    write = 4 * bl * h * p + 4 * chunks * h * n * p + 4 * bl * h
    return ssd_chunk_flops(cfg, rows, seq), float(read + write)


def ssd_bwd_cost(cfg: Dict, rows: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one call of the SSD backward: twice the
    forward's products; reads the forward's inputs and the three
    cotangents, writes the gradients of x, dt, A, B and C."""
    _, _, h, p, n, _, q = _dims(cfg)
    e = DTYPE_BYTES[cfg["dtype"]]
    bl, chunks = rows * seq, rows * (seq // q)
    inputs = e * bl * h * p + 4 * bl * h + 4 * h + 2 * e * bl * n
    cot = 4 * bl * h * p + 4 * chunks * h * n * p + 4 * bl * h
    return 2 * ssd_chunk_flops(cfg, rows, seq), float(2 * inputs + cot)

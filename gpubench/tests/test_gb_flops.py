"""The operation and byte counts against hand counts at one small shape:
d_model 4, expand 2 (d_inner 8), head dim 4 (2 heads), state 2, conv 2,
chunk 2, 1 layer, vocab 3; 1 row of 4 tokens (2 chunks)."""
import pytest

from gpubench.flops import ssm

CFG = {"d_model": 4, "num_layers": 1, "vocab_size": 3, "dtype": "bfloat16",
       "ssm": {"expand": 2, "head_dim": 4, "state_dim": 2,
               "conv_kernel": 2, "chunk_size": 2}}


def test_chunk_terms_by_hand():
    # per chunk: 3 causal pairs; C B^T 2*2*3 = 12; (C B^T o L)(x dt) for 2
    # heads of 4: 2*4*2*3 = 48; states 2*2*2*4*2 = 64; 2 chunks
    assert ssm.ssd_chunk_flops(CFG, 1, 4) == 2 * (12 + 48 + 64)


def test_layer_and_step_by_hand():
    proj = 2 * 4 * (4 * (2 * 8 + 2 * 2 + 2) + 8 * 4)   # 4 tokens
    conv = 2 * 4 * 2 * (8 + 2 * 2)
    off = 2 * 4 * 2 * 4 * 2
    layer = proj + conv + 248 + off
    assert ssm.layer_forward_flops(CFG, 1, 4) == layer
    head = 2 * 4 * 4 * 3
    assert ssm.step_flops(CFG, 1, 4) == 3 * (layer + head)


def test_kernel_bytes_by_hand():
    # x 4*2*4 bf16 = 64, dt 4*2 f32 = 32, A 8, B and C 4*2 bf16 = 32
    read = 64 + 32 + 8 + 32
    # y_diag 4*2*4 f32 = 128, states 2 chunks*2*2*4 f32 = 128, decay 32
    write = 128 + 128 + 32
    flops, nbytes = ssm.ssd_fwd_cost(CFG, 1, 4)
    assert (flops, nbytes) == (248, read + write)
    flops, nbytes = ssm.ssd_bwd_cost(CFG, 1, 4)
    assert (flops, nbytes) == (496, 2 * read + write)


def test_full_width_step_is_model_flops():
    """At Mamba-2 780M's widths the matmul part is 6 N T with N the
    parameters of the projections and the head."""
    from gpubench import bench
    cfg = bench.load_json(bench.ROOT / "gpubench/configs/mamba2-780m.json")
    d, di, n, h = 1536, 3072, 128, 48
    matmul = 48 * (d * (2 * di + 2 * n + h) + di * d) + d * cfg["vocab_size"]
    tokens = 16 * 2048
    total = ssm.step_flops(cfg, 16, 2048)
    assert total > 6 * matmul * tokens
    assert total == pytest.approx(6 * matmul * tokens, rel=0.1)

"""The port on the card: the CUDA tile-sweep, flash attention, LRU scan and
SSD scan kernels (the scans forward and backward) against their plain
PyTorch versions, the solver and the server (dense, MoE, Mamba-2,
RecurrentGemma), the encoder-decoder and VLM models and the recurrent
families' training on CUDA against the CPU, and
(given 4 cards) NCCL ranks against one rank: the solvers, the staged
all-reduce, MoE expert parallelism, the data-parallel and the ZeRO-3
trainer, the TP rings and the TP decode step; Qwen3-8B at full width
trained under streaming ZeRO-3 over 4 cards, trained tensor-parallel on
(1, 4) and (2, 2) ("data", "model") meshes, and served through the TP
decode step over 4 cards; the reduced Mamba-2, RecurrentGemma, Whisper
and LLaVA trained tensor-parallel on (2, 2) against one card, and
Mamba-2 780M and RecurrentGemma-2B (and Whisper-base) at full width on
4 cards, the scans' kernels on each rank's blocks (their rank-local
shapes checked on one card too); expert TP (Mixtral's widths, experts
that do not divide the 4 ranks) served and trained on 4 cards against
one, beside the dry run's memory estimate. Marked ``gpu``;
without a card every test here skips. Imports no jax, so it runs where the
JAX package is not installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

The tile sweep: f32 is compared bit for bit (the kernel does the plain
version's IEEE operations in the same order, with no FMA contraction) on
both of its paths (tiles held in a cluster's shared memory, and tiles too
large for that swept in global memory); bf16 within one bf16 ulp after the
cast. Flash attention: 2e-5 in f32 and 2e-2
in bf16, the JAX suite's tolerances (the kernel sums in another order and
rounds P to bf16 before P @ V). LRU scan: 1e-5 (the JAX suite's), bf16 h
within one bf16 ulp more (both round the f32 carry once, from carries a few
f32 ulps apart). SSD scan: y and the final state within 1e-4 for f32
inputs and 5e-2 for bf16 (the JAX suite's). RK3 and HPCCG on the card
against the CPU: within the JAX suite's tolerances (rtol 1e-5, atol 1e-6;
the history within rtol 1e-4), hdot equal to two_phase bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.halo import halo_scan_nd
from repro_torch.core.stencil import (heat2d_init, heat2d_solve,
                                      hpccg_solve, rk3_solve)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.heat2d import ops
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.mesh import make_grid_mesh, make_mesh

pytestmark = pytest.mark.gpu


def _gpu_lines() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


CASES = [  # (shape, tile, sweeps, halo, dtype, kernel path)
    ((64, 64), (32, 32), 1, False, torch.float32, "cluster_smem"),
    ((128, 96), (32, 48), 3, True, torch.float32, "cluster_smem"),
    ((63, 45), (7, 9), 2, True, torch.float32, "cluster_smem"),  # odd tile
    ((48, 40), (256, 256), 2, False, torch.float32,  # clamped tile
     "cluster_smem"),
    ((64, 64), (16, 16), 0, False, torch.float32, "cluster_smem"),
    ((64, 64), (16, 16), 2, True, torch.bfloat16, "cluster_smem"),
    # 256^2 tiles: row bands over a cluster, rows read across bands
    ((512, 512), (256, 256), 1, False, torch.float32, "cluster_smem"),
    ((512, 512), (256, 256), 4, False, torch.float32, "cluster_smem"),
    ((512, 512), (256, 256), 1, True, torch.float32, "cluster_smem"),
    ((512, 512), (256, 256), 4, True, torch.float32, "cluster_smem"),
    ((512, 512), (256, 256), 2, True, torch.bfloat16, "cluster_smem"),
    ((500, 400), (250, 200), 3, True, torch.float32,  # bands of 62, 63 rows
     "cluster_smem"),
    ((300, 294), (150, 147), 2, True, torch.float32,  # odd width, banded
     "cluster_smem"),
    # too large for a cluster's shared memory: swept in global memory
    ((2048, 2048), (1024, 1024), 2, True, torch.float32, "global"),
    ((2048, 2048), (1024, 1024), 1, False, torch.bfloat16, "global"),
]


@pytest.mark.parametrize("shape,tile,sweeps,halo,dtype,path", CASES)
def test_kernel_matches_plain(cuda, shape, tile, sweeps, halo, dtype, path):
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    u = u.to(cuda, dtype)
    ring = None
    if halo:
        nx, ny = shape
        ring = tuple(torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda, dtype)
            for s in ((1, ny), (1, ny), (nx, 1), (nx, 1)))
    before = ops.heat2d_sweep.launches
    got = ops.heat2d_sweep(u, tile, sweeps, "kernel", ring)
    torch.cuda.synchronize()
    assert ops.heat2d_sweep.launches == before + 1
    assert ops.heat2d_sweep.last_path == path
    want = ops.heat2d_sweep(u, tile, sweeps, "plain", ring)
    assert ops.heat2d_sweep.launches == before + 1
    assert got.dtype == dtype and got.shape == u.shape
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        _, e = torch.frexp(want.float().abs())
        ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                          (e - 8).to(torch.int32))
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


def test_kernel_plan_splits_a_256_tile_over_a_cluster(cuda):
    path, blocks, smem = ops.kernel_plan((256, 256))
    assert path == "cluster_smem" and blocks > 1
    assert smem <= 232448     # a block's shared memory on Hopper
    assert ops.kernel_plan((1024, 1024))[:2] == ("global", 0)
    assert ops.kernel_plan((7, 9))[:2] == ("cluster_smem", 1)


def test_solver_on_card_equals_cpu(cuda):
    u0 = heat2d_init(64, 64, device="cpu")
    for mesh_fn, axes in ((lambda d: make_mesh((1,), ("data",), d),
                           ("data",)),
                          (lambda d: make_grid_mesh(1, 1, device=d),
                           ("rows", "cols"))):
        for mode in ("two_phase", "hdot"):
            got, res = heat2d_solve(u0.to(cuda), mesh_fn(cuda), axes, 8, mode)
            want, wres = heat2d_solve(u0, mesh_fn("cpu"), axes, 8, mode)
            assert got.is_cuda and res.is_cuda
            assert torch.equal(got.cpu(), want)
            assert torch.equal(res.cpu(), wres)


def test_rk3_and_hpccg_on_card_equal_cpu(cuda):
    g = np.random.default_rng(3).standard_normal((8, 20, 32)).astype(
        np.float32)
    v0 = torch.from_numpy(g)
    for mesh_fn, axes in ((lambda d: make_mesh((1,), ("data",), d),
                           ("data",)),
                          (lambda d: make_grid_mesh(1, 1, device=d),
                           ("rows", "cols"))):
        got = {}
        for mode in ("two_phase", "hdot"):
            got[mode] = rk3_solve(v0.to(cuda), mesh_fn(cuda), axes, 3, 0.01,
                                  mode)
            want = rk3_solve(v0, mesh_fn("cpu"), axes, 3, 0.01, mode)
            assert got[mode].is_cuda
            np.testing.assert_allclose(got[mode].cpu().numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(got["hdot"], got["two_phase"])
    b = v0[:, :16, :16].contiguous()
    for mesh_fn, axes in ((lambda d: make_mesh((1,), ("data",), d),
                           ("data",)),
                          (lambda d: make_grid_mesh(1, 1, 1, device=d),
                           ("planes", "rows", "cols"))):
        got = {}
        for mode in ("two_phase", "hdot"):
            got[mode] = hpccg_solve(b.to(cuda), mesh_fn(cuda), axes, 20,
                                    mode)
            _, wh = hpccg_solve(b, mesh_fn("cpu"), axes, 20, mode)
            np.testing.assert_allclose(got[mode][1].cpu().numpy(),
                                       wh.numpy(), rtol=1e-4)
        for a, c in zip(got["hdot"], got["two_phase"]):
            assert torch.equal(a, c)


def test_sharded_sweep_launches_the_kernel(cuda):
    u = torch.randn((64, 64), device=cuda)
    before = ops.heat2d_sweep.launches
    got = ops.heat2d_sweep_sharded(u, make_grid_mesh(1, 1), ("rows", "cols"),
                                   (32, 32), 2)
    assert ops.heat2d_sweep.launches == before + 1
    assert torch.equal(got, ops.heat2d_sweep(u, (32, 32), 2, "plain"))


def test_nccl_2x2_ranks_match_one_rank(cuda, tmp_path):
    """Four NCCL ranks, one card each, on a (2, 2) grid: heat2d_solve in
    both schedules, the sharded sweep and the peeled scan equal one rank's
    results bit for bit, and the scan sends 4 exchanges per axis. On the
    same ranks: rk3_solve on (2, 2) and hpccg_solve on (1, 2, 2) against
    one rank within the JAX suite's tolerances (hdot bit-equal to
    two_phase, 3·steps and iters exchanges per axis of size 2), and
    hierarchical_allreduce on a (2, 2) (pod, data) mesh, plain (within 1e-4
    of the plain sum) and through the int8 codec (within 0.03 relative; the
    int16 payload sums exactly); and MoE expert parallelism on a (2, 2)
    (data, model) mesh, Q = 1 and 2, against the dense dispatch on one
    rank (_check_moe_ep_ranks); and the TP rings on a (4,) ring against
    numpy (rtol 1e-4; sends ring_permute_count a call) and the TP decode
    step on a (2, 2) (data, model) mesh, reduced qwen3-8b in float32,
    serving token for token what one rank serves (_check_tp_ranks)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from _torch_dist import _star, app_input, spawn

    u0 = np.random.default_rng(11).uniform(0.0, 1.0, (48, 40)).astype(
        np.float32)
    rk3 = dict(mesh=[2, 2], axes=["rows", "cols"], shape=[6, 32, 64], seed=5,
               steps=3, dt=0.01)
    hpccg = dict(mesh=[1, 2, 2], axes=["planes", "rows", "cols"],
                 shape=[8, 8, 16], seed=6, iters=12)
    moe = dict(mesh=[2, 2], axes=["data", "model"], seed=21, experts=8,
               top_k=2, factor=8.0, batch=4, seq=32, decode_batch=8,
               chunks=[1, 2], model_batch=4)
    job = dict(mesh=[2, 2], axes=["rows", "cols"], backend="nccl", iters=10,
               scan_steps=4, chunk_weights=[[9.0] * 6 + [1.0] * 16, None],
               sweep_tile=[8, 10], sweep_sweeps=2, rk3=rk3, hpccg=hpccg,
               allreduce=dict(mesh=[2, 2], shape=[16, 8], seed=100,
                              per_rank=True, odd_rows=5), moe=moe,
               tp_ring=dict(TP_RING, mesh=[4]),
               tp_decode=dict(TP_DECODE, mesh=[2, 2]))
    ranks = spawn(job, u0, tmp_path, 300)
    _check_moe_ep_ranks(ranks, moe, cuda)
    _check_tp_ranks(ranks, cuda)
    v0 = torch.from_numpy(app_input(rk3))
    want_rk3 = rk3_solve(v0, make_grid_mesh(1, 1, device="cpu"),
                         ("rows", "cols"), 3, 0.01, "two_phase").numpy()
    b = torch.from_numpy(app_input(hpccg))
    _, want_hist = hpccg_solve(b, make_grid_mesh(1, 1, 1, device="cpu"),
                               ("planes", "rows", "cols"), 12, "two_phase")
    xs = [app_input(job["allreduce"], r) for r in range(4)]
    q_sum = [sum(np.random.default_rng(r).integers(-127, 128, (33,))
                 for r in line) for line in ((0, 2), (1, 3))]
    for r, out in enumerate(ranks):
        for mode in ("two_phase", "hdot"):
            np.testing.assert_allclose(out[f"rk3_{mode}"], want_rk3,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(out[f"hpccg_hist_{mode}"],
                                       want_hist.numpy(), rtol=1e-4)
            assert out[f"rk3_sends_{mode}"].tolist() == [9, 9]
            assert out[f"hpccg_sends_{mode}"].tolist() == [0, 12, 12]
        for key in ("rk3_{}", "hpccg_{}", "hpccg_hist_{}"):
            np.testing.assert_array_equal(out[key.format("hdot")],
                                          out[key.format("two_phase")])
        plain = out["ar_plain"]
        np.testing.assert_allclose(plain, sum(xs), rtol=1e-5, atol=1e-5)
        assert np.abs(out["ar_staged"] - plain).max() < 1e-4
        assert (np.abs(out["ar_comp"] - plain).max()
                / (np.abs(plain).max() + 1e-9)) < 0.03
        np.testing.assert_array_equal(out["ar_odd"], out["ar_odd_plain"])
        np.testing.assert_array_equal(out["int16_sum"], q_sum[r % 2])
    one = make_grid_mesh(1, 1, device="cpu")
    ut = torch.from_numpy(u0)
    want, wres = heat2d_solve(ut, one, ("rows", "cols"), 10, "two_phase")
    sweep = ops.heat2d_sweep(ut, (8, 10), 2)
    scans = {tag: halo_scan_nd(ut, _star, one, (("rows", 0), ("cols", 1)), 1,
                               4, periodic, "hdot", 2)[0]
             for tag, periodic in (("open", False), ("periodic", True))}
    for out in ranks:
        for mode in ("two_phase", "hdot"):
            np.testing.assert_array_equal(out[f"solve_{mode}"], want.numpy())
            np.testing.assert_array_equal(out[f"res_{mode}"], wres.numpy())
        np.testing.assert_array_equal(out["sweep"], sweep.numpy())
        for tag, scan in scans.items():
            np.testing.assert_array_equal(out[f"scan_{tag}"], scan.numpy())
            assert out[f"sends_{tag}"].tolist() == [4, 4]


# tests/test_torch_dist.py's RING and TP jobs
TP_RING = dict(seed=30, rows=15, cols=4, m=8)
TP_DECODE = dict(layers=2, heads=[8, 4], seed=0, slots=4, max_len=16)


def _check_tp_ranks(ranks, device):
    """The TP jobs on the ranks: every ring output within rtol 1e-4 of
    numpy's product (the JAX suite's bound), hdot within 1e-5 of
    two_phase, ring_permute_count sends a hdot call; the TP decode step
    on (2, 2), both modes, serves the one-rank server's tokens on `device`
    (the card) token for token, with expected_permute_total sends a hdot
    step, and its teacher-forced logits within 1e-4 of model.decode_step
    on the card (the f32 model tolerance)."""
    from _torch_dist import (RING_CASES, ring_input, tp_admitted, tp_model,
                             tp_serve)

    from repro_torch.core.collective_matmul import ring_permute_count
    from repro_torch.models.decode_tp import expected_permute_total

    x, w, h, v = ring_input(TP_RING, 4)
    rows, cols = TP_RING["rows"], TP_RING["cols"]
    torch.backends.cuda.matmul.allow_tf32 = False
    model, params = tp_model(TP_DECODE, device)
    tokens, stats = tp_serve(model, params, TP_DECODE)
    logits, _ = model.decode_step(params, *tp_admitted(model, params,
                                                       TP_DECODE, device))
    per_step = expected_permute_total(model.cfg, TP_DECODE["slots"], 2, 2)
    for r, out in enumerate(ranks):
        want = {"ag": (x @ w)[:, r * cols:(r + 1) * cols],
                "rs": (h @ v)[r * rows:(r + 1) * rows]}
        for mode, chunks in RING_CASES:
            for op in ("ag", "rs"):
                got = out[f"ring_{op}_{mode}_{chunks}"]
                np.testing.assert_allclose(got, want[op], rtol=1e-4,
                                           atol=1e-4)
                np.testing.assert_allclose(
                    got, out[f"ring_{op}_two_phase_None"], rtol=1e-5,
                    atol=1e-5)
                assert int(out[f"ring_{op}_{mode}_{chunks}_sends"]) == (
                    ring_permute_count(rows, 4, chunks=chunks)
                    if mode == "hdot" else 0)
        for mode in ("hdot", "two_phase"):
            np.testing.assert_array_equal(out[f"tp_{mode}_tokens"], tokens)
            steps = int(out[f"tp_{mode}_decode_steps"])
            assert steps == stats["decode_steps"]
            assert int(out[f"tp_{mode}_sends"]) == (
                per_step * steps if mode == "hdot" else 0)
            np.testing.assert_allclose(out[f"tp_{mode}_logits"],
                                       logits.cpu().numpy(), rtol=1e-4,
                                       atol=1e-4)


def _check_moe_ep_ranks(ranks, spec, device):
    """The MoE job's results on the ranks (tests/_torch_dist.py run_moe)
    against the port's moe_apply_dense on one rank on the CPU, on the whole
    input (ample capacity: the same function): y within 1e-5 of the
    largest entry, the global loss sum(y^2) + aux within 1e-3 (1 + |loss|)
    and the gradients within 2e-3 (the JAX suite's bounds,
    tests/test_moe_ep.py), the decode step (the batch as tokens) within
    2e-4; Q = 2 gives Q = 1's y and loss bit for bit; the reduced model
    built on the mesh (expert parallelism in every MoE block) within 1e-4
    of the same model's logits on one rank on `device`, the card. (Against
    the CPU its decode logits differ by up to 1.4e-4: this draw's router
    has top-2 and third probabilities 5.5e-8 apart, and the card's and the
    CPU's float32 orders move the model's output that far; on one card
    they are within 1.7e-5 of the ranks'.)"""
    from _torch_dist import moe_config, moe_input, moe_model_tokens

    from repro_torch.models import moe
    from repro_torch.models.model import ModelOptions, build_model

    cfg = moe_config(spec)
    p_np, x, xd = moe_input(spec)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in p_np.items()}
    y, aux = moe.moe_apply_dense(p, torch.from_numpy(x), cfg)
    loss = (y * y).sum() + aux
    loss.backward()
    y, loss = y.detach().numpy(), float(loss.detach())
    yd = moe.moe_apply_dense({k: v.detach() for k, v in p.items()},
                             torch.from_numpy(xd), cfg)[0].numpy()
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.float32))
    params = model.init(0, "cpu").to(device)
    toks = torch.from_numpy(moe_model_tokens(spec)).to(device)
    s = spec["seq"]
    lp, caches = model.prefill(params, {"tokens": toks[:, :s]},
                               max_len=s + 1)
    ld, _ = model.decode_step(params, toks[:, s:], caches, s)
    lp, ld = lp.cpu().numpy(), ld.cpu().numpy()
    for out in ranks:
        rows = out["moe_model_prefill"].shape[0]
        d = int(out["moe_data_coord"])
        assert int(out["moe_model_a2a_calls"]) == 2 * cfg.num_layers * 2
        for got, want in ((out["moe_model_prefill"], lp),
                          (out["moe_model_decode"], ld)):
            np.testing.assert_allclose(got, want[d * rows:(d + 1) * rows],
                                       rtol=1e-4, atol=1e-4)
        d = int(out["moe_data_coord"])
        rows = out["moe_y_q1"].shape[0]
        np.testing.assert_allclose(out["moe_y_q1"], y[d * rows:(d + 1) * rows],
                                   rtol=0, atol=1e-5 * np.abs(y).max())
        got = float(out["moe_loss_q1"])
        assert abs(got - loss) < 1e-3 * (1 + abs(loss))
        for k, v in p.items():
            assert np.abs(out[f"moe_grad_{k}_q1"]
                          - v.grad.numpy()).max() < 2e-3, k
        np.testing.assert_array_equal(out["moe_y_q2"], out["moe_y_q1"])
        assert out["moe_loss_q2"] == out["moe_loss_q1"]
        assert str(out["moe_route_decode"]) == "ep_batch"
        rows = out["moe_y_decode"].shape[0]
        assert np.abs(out["moe_y_decode"]
                      - yd[d * rows:(d + 1) * rows]).max() < 2e-4


def test_nccl_2x2_trainer_matches_one_rank(cuda, tmp_path):
    """Four NCCL ranks, one card each, train the reduced internlm2-1.8b
    (float32, unrolled layers, the port's init from seed 0) on a (2, 2)
    ("pod", "data") mesh for 3 steps under hdot and two_phase, with 1 and
    2 microbatches: every rank holds the same state; hdot matches
    two_phase, and both match the port on one card with the global batch,
    at rtol 1e-4 (losses, grad norms; parameters leaf by leaf, relative to
    each leaf's largest entry); every rank issues its buckets in
    make_buckets' reverse-topological order, the head's and layers
    4..2's before layer 1's first gradient is ready."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from _torch_dist import check_issue_order, params_close, spawn

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.trainer import Trainer

    spec = dict(arch="internlm2-1.8b", steps=3, global_batch=8, seq_len=32,
                lr=5e-3, mesh=[2, 2], axes=["pod", "data"],
                cases=[["hdot", 1], ["two_phase", 1], ["hdot", 2],
                       ["two_phase", 2]])
    cfg = get_arch(spec["arch"]).reduced()
    opts = ModelOptions(dtype=torch.float32, scan_layers=False)
    params = build_model(cfg, opts).init(0, "cpu")
    save_checkpoint(str(tmp_path / "init"), 0,
                    {"params": params, "opt": adamw_init(params)},
                    extra={"data_step": 0})
    ranks = spawn(dict(mesh=[2, 2], backend="nccl", train=spec), None,
                  tmp_path, 300)
    check_issue_order(ranks, spec)
    leaves = tree_leaves(params)
    for accum in (1, 2):
        one = Trainer(RunConfig(
            model=cfg,
            parallel=ParallelConfig(accum_steps=accum, remat="none",
                                    scan_layers=False),
            train=TrainConfig(global_batch=8, seq_len=32, lr=5e-3,
                              warmup_steps=2, total_steps=3,
                              checkpoint_every=10 ** 6, seed=3,
                              checkpoint_dir=str(tmp_path / "init"))),
            options=opts, device=cuda)
        one.train(3)
        want = {k: [m[k] for m in one.metrics_log]
                for k in ("loss", "grad_norm")}
        want_p = torch.cat([p.detach().reshape(-1) for p in
                            tree_leaves(one.params)]).cpu().numpy()
        for overlap in ("hdot", "two_phase"):
            tag = f"{overlap}{accum}"
            for out in ranks:
                for key in ("loss", "grad_norm", "params"):
                    np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                                  ranks[0][f"{tag}_{key}"])
            got = ranks[0]
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[f"{tag}_{key}"], want[key],
                                           rtol=1e-4)
                np.testing.assert_allclose(
                    got[f"{tag}_{key}"], got[f"two_phase{accum}_{key}"],
                    rtol=1e-4)
            params_close(got[f"{tag}_params"], want_p, leaves)
            params_close(got[f"{tag}_params"],
                         got[f"two_phase{accum}_params"], leaves)


def test_nccl_2x2_zero3_matches_one_rank(cuda, tmp_path):
    """Four NCCL ranks, one card each, train the reduced qwen3-8b (float32,
    unrolled, remat "full", the unfused loss, 3 steps) under ZeRO-3 on a
    (2, 2) ("pod", "data") mesh, gathering all and streaming on the
    per-layer layout: every rank reports the same losses, grad norms and
    full parameters; streaming equals gathering all bit for bit (the same
    buffers reduced at the same sizes); both match the replicated trainer
    on one card with the global batch (losses and grad norms rtol 1e-5,
    parameters within 1e-4 of each leaf's largest entry, as on gloo);
    each rank holds padded / 4 of every buffer, the padding stays zero,
    and the collectives follow the schedule (check_zero3_log)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from _torch_dist import (check_zero3_log, params_close, spawn,
                             zero3_trainer)

    from repro_torch.models.layers import tree_leaves

    spec = dict(arch="qwen3-8b", steps=3, global_batch=8, seq_len=16,
                lr=5e-3, cases=["gather", "stream"], mesh=[2, 2],
                axes=["pod", "data"])
    ranks = spawn(dict(mesh=[2, 2], backend="nccl", zero3=spec), None,
                  tmp_path, 300)
    one = zero3_trainer(spec, "repl", None, cuda)
    one.init_state(seed=0)
    one.train(spec["steps"])
    want_p = torch.cat([p.detach().reshape(-1) for p in
                        tree_leaves(one.params)]).cpu().numpy()
    leaves = tree_leaves(one.params)
    for case in spec["cases"]:
        tag = f"z3{case}"
        for out in ranks:
            for key in ("loss", "grad_norm", "params"):
                np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                              ranks[0][f"{tag}_{key}"])
            assert (out[f"{tag}_shard_sizes"] * 4 == out[f"{tag}_padded"]
                    ).all()
            assert bool(out[f"{tag}_pad_zero"])
            check_zero3_log(out[f"{tag}_log"], out[f"{tag}_keys"],
                            case == "stream", spec["steps"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0][f"{tag}_{key}"],
                                       [m[key] for m in one.metrics_log],
                                       rtol=1e-5)
        params_close(ranks[0][f"{tag}_params"], want_p, leaves)
    for out in ranks:
        for key in ("loss", "grad_norm", "params", "shard_p", "shard_m",
                    "shard_v"):
            np.testing.assert_array_equal(out[f"z3stream_{key}"],
                                          out[f"z3gather_{key}"])


def test_nccl_4_zero3_trains_qwen3_8b_full_width(cuda, tmp_path):
    """Qwen3-8B at its published widths (36 layers, d_model 4096, 32/8
    heads of 128, d_ff 12288, vocab 151936, untied; 8.19 B parameters,
    98 GB of bf16 params and grads and f32 AdamW moments: more than one
    card holds) trains under streaming ZeRO-3 over four NCCL ranks, one
    card each, on a (4,) ("data",) mesh: random bf16 weights from seed 0,
    global batch 8 x 2048 tokens (2 x 2048 a card), a warm-up step and 3
    timed steps, then one traced step. Holds: the losses finite and
    equal on every rank, the first within 0.5 of ln V + 1/2, and every
    card's peak under 80 GiB. Prints one JSON line: step ms, tokens/s per card and in total, MFU
    (6·N·tokens, N the parameters less the embedding, over 989 TFLOP/s a
    card), the peak GiB of each card, and rank 0's traced NCCL time that
    no compute kernel overlaps."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json
    import math

    from _torch_dist import spawn

    from repro_torch.config.registry import get_arch

    spec = dict(arch="qwen3-8b", steps=4, global_batch=8, seq_len=2048,
                lr=3e-4, mesh=[4], trace=True)
    ranks = spawn(dict(mesh=[4], backend="nccl", zero3_full=spec), None,
                  tmp_path, 900)
    cfg = get_arch("qwen3-8b")
    for out in ranks:
        assert np.isfinite(out["loss"]).all()
        np.testing.assert_array_equal(out["loss"], ranks[0]["loss"])
        assert out["peak_bytes"] < 80 * 2 ** 30
    first = float(ranks[0]["loss"][0])
    assert abs(first - (math.log(cfg.vocab_size) + 0.5)) <= 0.5, first
    step_s = float(np.median(ranks[0]["step_s"][1:]))
    tokens = spec["global_batch"] * spec["seq_len"]
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.d_model
    print(json.dumps({
        "test": "zero3_qwen3_8b_full_width", "cards": 4,
        "gpu": torch.cuda.get_device_name(0),
        "init_s": float(ranks[0]["init_s"]),
        "step_ms": [1e3 * x for x in ranks[0]["step_s"][1:].tolist()],
        "step_ms_median": 1e3 * step_s,
        "warmup_step_ms": 1e3 * float(ranks[0]["step_s"][0]),
        "tokens_per_s": tokens / step_s,
        "tokens_per_s_per_card": tokens / step_s / 4,
        "mfu": 6 * n_matmul * tokens / step_s / (4 * 989e12),
        "peak_gib": [float(o["peak_bytes"]) / 2 ** 30 for o in ranks],
        "param_shard_gib": float(ranks[0]["shard_bytes"]) / 2 ** 30,
        "losses": ranks[0]["loss"].tolist(),
        "grad_norms": ranks[0]["grad_norm"].tolist(),
        "traced_step_rank0": {k: float(ranks[0][k]) for k in
                              ("nccl_ms", "compute_ms", "nccl_exposed_ms")},
    }))


def test_nccl_4_tp_trains_qwen3_8b_full_width(cuda, tmp_path):
    """Tensor-parallel training over four NCCL ranks, one card each.

    First, reduced Qwen3-8B (scanned, remat "full") and Granite-3-2B (tied,
    2 microbatches), float32, on a (2, 2) ("data", "model") mesh for 3
    steps from the port's init: every rank reports the same, and losses,
    grad norms and parameters match one card training the global batch at
    rtol 1e-4, as on gloo.

    Then Qwen3-8B at its published widths (36 layers, d_model 4096, 32/8
    heads of 128, d_ff 12288, vocab 151936, untied; 98 GB of bf16 params
    and grads and f32 AdamW moments), bf16, unrolled, remat "full", 8 x
    2048 tokens a step, trained on (1, 4) and on (2, 2), each from seed 0
    (every rank drawing leaf by leaf and keeping its blocks): a warm-up
    step and 3 timed steps, then one traced step. Holds: the losses finite
    and equal on every rank, every card's peak under 80 GiB, the bytes at
    rest within 1% above the sum of the rank's blocks (params and
    moments), and the first loss within a bound B of one card's forward of
    the same weights on the same batch. B is one bf16 spacing at the
    loss's magnitude, 2^(floor(log2 L) - 7) for L the loss with the same
    weights widened to float32 (1/16 at L ~ 12): both runs take the mean
    of 16384 float32 per-token losses over bf16 activations from the same
    weights and tokens and differ only in the order of their roundings
    (the TP run sums its ranks' partial products in bf16), whose errors of
    either sign average over the tokens, so a whole bf16 spacing of the
    loss itself marks a fault in the cut, not rounding; the one-card bf16
    loss is held within B of the float32 one too. Prints one JSON line a
    mesh: step ms, tokens/s, MFU (6·N·tokens, N the parameters less the
    embedding, over 989 TFLOP/s a card), peak and at-rest GiB a card, the
    losses, and rank 0's traced NCCL time that no compute kernel
    overlaps."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json
    import math

    from _torch_dist import (flat, params_close, spawn, tp_full_reference,
                             tp_init_key, tp_run)

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.config.registry import get_arch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.trainer import Trainer

    small = dict(steps=3, global_batch=8, seq_len=16, lr=5e-3,
                 total_steps=6, mesh=[2, 2], axes=["data", "model"],
                 cases=[dict(tag="q1", arch="qwen3-8b", accum=1, scan=True,
                             remat="full"),
                        dict(tag="g2", arch="granite-3-2b", accum=2,
                             scan=False)])
    for case in small["cases"]:
        run, opts = tp_run(small, case, tmp_path)
        p = build_model(run.model, opts).init(0, "cpu")
        save_checkpoint(str(tmp_path / f"init_{tp_init_key(case)}"), 0,
                        {"params": p, "opt": adamw_init(p)},
                        extra={"data_step": 0})
    full = dict(arch="qwen3-8b", steps=4, global_batch=8, seq_len=2048,
                lr=3e-4, meshes=[[1, 4], [2, 2]], trace=True)
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_train=small,
                       tp_train_full=full), None, tmp_path, 900)
    for case in small["cases"]:
        tag = case["tag"]
        run, opts = tp_run(small, case,
                           tmp_path / f"init_{tp_init_key(case)}")
        one = Trainer(run, options=opts, device=cuda)
        assert one.restore_if_available()
        one.train(small["steps"])
        for out in ranks:
            for key in ("loss", "grad_norm", "params"):
                np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                              ranks[0][f"{tag}_{key}"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0][f"{tag}_{key}"],
                                       [m[key] for m in one.metrics_log],
                                       rtol=1e-4)
        params_close(ranks[0][f"{tag}_params"], flat(one.params),
                     tree_leaves(one.params))
        del one
    torch.cuda.empty_cache()
    ref = tp_full_reference(full, cuda)
    bound = 2.0 ** (math.floor(math.log2(ref["f32"])) - 7)
    assert abs(ref["one"] - ref["f32"]) <= bound, ref
    cfg = get_arch("qwen3-8b")
    tokens = full["global_batch"] * full["seq_len"]
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.d_model
    for shape in full["meshes"]:
        tag = "m" + "x".join(map(str, shape))
        for out in ranks:
            assert np.isfinite(out[f"{tag}_loss"]).all()
            np.testing.assert_array_equal(out[f"{tag}_loss"],
                                          ranks[0][f"{tag}_loss"])
            assert out[f"{tag}_peak_bytes"] < 80 * 2 ** 30
            rest, blocks = (int(out[f"{tag}_rest_bytes"]),
                            int(out[f"{tag}_block_bytes"]))
            assert blocks <= rest <= 1.01 * blocks, (rest, blocks)
        first = float(ranks[0][f"{tag}_loss"][0])
        assert abs(first - ref["one"]) <= bound, (first, ref)
        r0 = ranks[0]
        step_s = float(np.median(r0[f"{tag}_step_s"][1:]))
        print(json.dumps({
            "test": "tp_train_qwen3_8b_full_width", "mesh": shape,
            "cards": 4, "gpu": torch.cuda.get_device_name(0),
            "init_s": float(r0[f"{tag}_init_s"]),
            "step_ms": [1e3 * x for x in r0[f"{tag}_step_s"][1:].tolist()],
            "step_ms_median": 1e3 * step_s,
            "warmup_step_ms": 1e3 * float(r0[f"{tag}_step_s"][0]),
            "tokens_per_s": tokens / step_s,
            "tokens_per_s_per_card": tokens / step_s / 4,
            "mfu": 6 * n_matmul * tokens / step_s / (4 * 989e12),
            "peak_gib": [float(o[f"{tag}_peak_bytes"]) / 2 ** 30
                         for o in ranks],
            "rest_gib": [float(o[f"{tag}_rest_bytes"]) / 2 ** 30
                         for o in ranks],
            "block_gib": [float(o[f"{tag}_block_bytes"]) / 2 ** 30
                          for o in ranks],
            "losses": r0[f"{tag}_loss"].tolist(),
            "grad_norms": r0[f"{tag}_grad_norm"].tolist(),
            "first_loss_one_card": ref["one"], "first_loss_f32": ref["f32"],
            "bound": bound,
            "traced_step_rank0": {k: float(r0[f"{tag}_{k}"]) for k in
                                  ("nccl_ms", "compute_ms",
                                   "nccl_exposed_ms")},
        }))


def _adam_params_close(got, one, rtol=1e-4):
    """A flattened parameter vector against a one-card Trainer's tree:
    within `rtol` of each leaf's largest entry, except where the one
    card's AdamW second moment is below (1e3 * eps)^2, where an entry may
    differ by up to the summed learning rates (the rule of
    test_recurrent_trained_on_card_equals_cpu)."""
    from repro_torch.models.layers import tree_leaves

    eps, lr_sum = one.opt_cfg.eps, sum(m["lr"] for m in one.metrics_log)
    off = 0
    for p, v in zip(tree_leaves(one.params), tree_leaves(one.opt_state["v"])):
        n = p.numel()
        a = got[off:off + n]
        b = p.detach().float().reshape(-1).cpu().numpy()
        v = v.detach().reshape(-1).cpu().numpy()
        tiny = (v > 0) & (v < (1e3 * eps) ** 2)
        np.testing.assert_allclose(a[~tiny], b[~tiny], rtol=rtol,
                                   atol=rtol * np.abs(b).max())
        assert (np.abs(a[tiny] - b[tiny]) <= lr_sum).all()
        off += n
    assert off == len(got)


def _unrolled_init(cfg, opts):
    """The port's seed-0 parameters drawn unrolled (each layer's leaves
    with their own fan-in), in `opts`' layout: a scanned draw takes fan_in
    = the layer count (ROADMAP.md Queue 3), whose large weights amplify
    the TP run's other rounding order to ~1e-4 in the third step's grad
    norm (reduced Mamba-2 on the card: 10.28712 against 10.28891), as the
    gloo tests found for the dense family."""
    import dataclasses

    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.layers import leaf_paths, rebuild, tree_leaves
    from repro_torch.models.model import build_model

    model = build_model(cfg, dataclasses.replace(opts, scan_layers=False))
    specs = model.param_specs()
    arrays = {p: t.detach().numpy() for p, t in
              zip(leaf_paths(specs), tree_leaves(model.init(0, "cpu")))}
    return params_from_jax(rebuild(specs, arrays), cfg, opts, "cpu")


TP_FAMILY_CASES = [  # reduced, float32, on a (2, 2) ("data", "model") mesh
    dict(tag="m1", arch="mamba2-780m", accum=1, scan=True, remat="full"),
    dict(tag="r2", arch="recurrentgemma-2b", accum=2, scan=False),
    dict(tag="w1", arch="whisper-base", accum=1, scan=False, remat="full"),
    dict(tag="l1", arch="llava-next-34b", accum=1, scan=False, seq=24)]


def test_nccl_2x2_tp_trains_other_families_match_one_card(cuda, tmp_path):
    """Reduced Mamba-2 (scanned, remat "full"), RecurrentGemma (2
    microbatches), Whisper-base (remat "full") and LLaVA-NeXT-34B (16
    patches before 24 tokens, so a rank's rows hold patches and text),
    float32, trained tensor-parallel over four NCCL ranks on a (2, 2)
    ("data", "model") mesh for 3 steps from the port's init drawn
    unrolled (:func:`_unrolled_init`): every rank
    reports the same losses, grad norms and parameters, and they match
    one card training the global batch (losses and grad norms at rtol
    1e-4, parameters as :func:`_adam_params_close` holds them). The scans
    run their kernels forward and backward on each rank's heads or width
    block: each rank counts 2 forward launches (remat "full") or 1 and 1
    backward launch a recurrent layer a microbatch, and no plain scan."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from _torch_dist import spawn, tp_init_key, tp_run

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models.transformer import block_kinds
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(steps=3, global_batch=8, seq_len=16, lr=5e-3,
                 total_steps=6, mesh=[2, 2], axes=["data", "model"],
                 cases=TP_FAMILY_CASES)
    for case in small["cases"]:
        run, opts = tp_run(small, case, tmp_path)
        p = _unrolled_init(run.model, opts)
        save_checkpoint(str(tmp_path / f"init_{tp_init_key(case)}"), 0,
                        {"params": p, "opt": adamw_init(p)},
                        extra={"data_step": 0})
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_train=small), None,
                  tmp_path, 600)
    for case in small["cases"]:
        tag = case["tag"]
        run, opts = tp_run(small, case,
                           tmp_path / f"init_{tp_init_key(case)}")
        kinds = block_kinds(run.model)
        per_pass = (2 if case.get("remat") == "full" else 1)
        micro = small["steps"] * case["accum"]
        want = [0, 0, 0, 0]      # ssd fwd, ssd bwd, lru fwd, lru bwd
        for k, at in (("ssm", 0), ("rglru", 2)):
            n = kinds.count(k)
            want[at], want[at + 1] = n * per_pass * micro, n * micro
        for out in ranks:
            for key in ("loss", "grad_norm", "params"):
                np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                              ranks[0][f"{tag}_{key}"])
            assert out[f"{tag}_launches"].tolist() == want, (tag, want)
            assert out[f"{tag}_plain_calls"].tolist() == [0, 0], tag
        one = Trainer(run, options=opts, device=cuda)
        assert one.restore_if_available()
        one.train(small["steps"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0][f"{tag}_{key}"],
                                       [m[key] for m in one.metrics_log],
                                       rtol=1e-4)
        _adam_params_close(ranks[0][f"{tag}_params"], one)
        del one
        torch.cuda.empty_cache()


TP_FULL = [  # (arch, scanned, meshes, global batch, tokens a row)
    ("mamba2-780m", True, [[1, 4], [2, 2]], 8, 2048),
    ("recurrentgemma-2b", False, [[1, 4], [2, 2]], 8, 2048),
    ("whisper-base", False, [[1, 4]], 16, 448)]


def test_nccl_4_tp_trains_recurrent_families_full_width(cuda, tmp_path):
    """Mamba-2 780M (scanned; 48 SSD heads of 64, 12 a rank at (1, 4) and
    24 at (2, 2)) and RecurrentGemma-2B (LRU width 2560, 640 or 1280 a
    rank; its vocab of 256000 placed on "model"; its 10 heads replicated
    at tp 4, 5 a rank at tp 2) at their published widths, bf16, remat
    "full", 8 x 2048 tokens a step, trained tensor-parallel over four NCCL
    ranks on (1, 4) and (2, 2) ("data", "model") meshes, and Whisper-base
    (16 x 448 tokens, 16 x 1500 float32 stub frames; its vocab of 51865
    replicated) on (1, 4), each from seed 0: a warm-up step and 3 timed
    steps, then one traced step. Holds: the losses finite and equal on
    every rank, every card's peak under 80 GiB, the bytes at rest within
    1% above the sum of the rank's blocks, the first loss within one bf16
    spacing of one card's forward of the same weights on the same batch
    (the bound of test_nccl_4_tp_trains_qwen3_8b_full_width), and on every
    rank exactly 2 forward launches and 1 backward launch of the scan
    kernel a recurrent layer a step, and no call of a plain scan. Prints
    one JSON line a model and mesh: step ms, tokens/s, MFU (6·N·tokens, N
    the parameters less the embedding, over 989 TFLOP/s a card), peak and
    at-rest GiB a card, the launches of each rank, the losses, and rank
    0's traced NCCL time that no compute kernel overlaps."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json
    import math

    from _torch_dist import spawn, tp_full_reference

    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import block_kinds

    specs = [dict(arch=arch, scan=scan, steps=4, global_batch=gb,
                  seq_len=seq, lr=3e-4, meshes=meshes, trace=True,
                  prefix=arch.split("-")[0] + "_")
             for arch, scan, meshes, gb, seq in TP_FULL]
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_train_full=specs),
                  None, tmp_path, 1500)
    for spec in specs:
        cfg = get_arch(spec["arch"])
        torch.cuda.empty_cache()
        ref = tp_full_reference(spec, cuda)
        bound = 2.0 ** (math.floor(math.log2(ref["f32"])) - 7)
        assert abs(ref["one"] - ref["f32"]) <= bound, (spec["arch"], ref)
        kinds = block_kinds(cfg)
        steps = spec["steps"]
        want = [2 * steps * kinds.count("ssm"), steps * kinds.count("ssm"),
                2 * steps * kinds.count("rglru"),
                steps * kinds.count("rglru")]
        tokens = spec["global_batch"] * spec["seq_len"]
        n_matmul = cfg.num_params() - cfg.vocab_size * cfg.d_model
        for shape in spec["meshes"]:
            tag = spec["prefix"] + "m" + "x".join(map(str, shape))
            for out in ranks:
                assert np.isfinite(out[f"{tag}_loss"]).all()
                np.testing.assert_array_equal(out[f"{tag}_loss"],
                                              ranks[0][f"{tag}_loss"])
                assert out[f"{tag}_peak_bytes"] < 80 * 2 ** 30
                rest, blocks = (int(out[f"{tag}_rest_bytes"]),
                                int(out[f"{tag}_block_bytes"]))
                assert blocks <= rest <= 1.01 * blocks, (rest, blocks)
                assert out[f"{tag}_launches"].tolist() == want, tag
                assert out[f"{tag}_plain_calls"].tolist() == [0, 0], tag
            r0 = ranks[0]
            first = float(r0[f"{tag}_loss"][0])
            assert abs(first - ref["one"]) <= bound, (tag, first, ref)
            step_s = float(np.median(r0[f"{tag}_step_s"][1:]))
            print(json.dumps({
                "test": "tp_train_full_width", "arch": spec["arch"],
                "mesh": shape, "cards": 4,
                "gpu": torch.cuda.get_device_name(0),
                "init_s": float(r0[f"{tag}_init_s"]),
                "step_ms": [1e3 * x
                            for x in r0[f"{tag}_step_s"][1:].tolist()],
                "step_ms_median": 1e3 * step_s,
                "warmup_step_ms": 1e3 * float(r0[f"{tag}_step_s"][0]),
                "tokens_per_s": tokens / step_s,
                "mfu": 6 * n_matmul * tokens / step_s / (4 * 989e12),
                "n_matmul": n_matmul,
                "peak_gib": [float(o[f"{tag}_peak_bytes"]) / 2 ** 30
                             for o in ranks],
                "rest_gib": [float(o[f"{tag}_rest_bytes"]) / 2 ** 30
                             for o in ranks],
                "block_gib": [float(o[f"{tag}_block_bytes"]) / 2 ** 30
                              for o in ranks],
                "launches_per_rank": [o[f"{tag}_launches"].tolist()
                                      for o in ranks],
                "losses": r0[f"{tag}_loss"].tolist(),
                "grad_norms": r0[f"{tag}_grad_norm"].tolist(),
                "first_loss_one_card": ref["one"],
                "first_loss_f32": ref["f32"], "bound": bound,
                "traced_step_rank0": {k: float(r0[f"{tag}_{k}"]) for k in
                                      ("nccl_ms", "compute_ms",
                                       "nccl_exposed_ms")},
            }), flush=True)


TP_MOE_CASES = [  # reduced Qwen3-30B-A3B, float32, ample capacity (E / K)
    dict(tag="q1", arch="qwen3-moe-30b-a3b", accum=1, scan=False,
         remat="full", capacity=2.0, chunks=1, log=True),
    dict(tag="q2", arch="qwen3-moe-30b-a3b", accum=1, scan=False,
         remat="dots", capacity=2.0, chunks=2, log=True)]


def test_nccl_2x2_tp_trains_moe_matches_one_card(cuda, tmp_path):
    """Reduced Qwen3-30B-A3B (4 experts, top 2, a capacity factor of E / K
    so no token is dropped and expert parallelism is the dense dispatch),
    float32, trained tensor-parallel over four NCCL ranks on a (2, 2)
    ("data", "model") mesh for 3 steps, the experts over "model" (2 a
    rank), at ``moe_a2a_chunks`` Q = 1 (remat "full") and Q = 2 (remat
    "dots"), from the port's init drawn unrolled: every rank reports the
    same losses, grad norms and parameters and logs the same all-to-alls,
    and they match one card training the global batch (losses and grad
    norms at rtol 1e-4, parameters as :func:`_adam_params_close` holds
    them)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from _torch_dist import spawn, tp_init_key, tp_run

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(steps=3, global_batch=8, seq_len=16, lr=5e-3,
                 total_steps=6, mesh=[2, 2], axes=["data", "model"],
                 cases=TP_MOE_CASES)
    run, opts = tp_run(small, small["cases"][0], tmp_path)
    p = _unrolled_init(run.model, opts)
    save_checkpoint(str(tmp_path / f"init_{tp_init_key(small['cases'][0])}"),
                    0, {"params": p, "opt": adamw_init(p)},
                    extra={"data_step": 0})
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_train=small), None,
                  tmp_path, 600)
    for case in small["cases"]:
        tag = case["tag"]
        for out in ranks:
            for key in ("loss", "grad_norm", "params", "a2a"):
                np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                              ranks[0][f"{tag}_{key}"])
        run, opts = tp_run(small, case,
                           tmp_path / f"init_{tp_init_key(case)}")
        one = Trainer(run, options=opts, device=cuda)
        assert one.restore_if_available()
        one.train(small["steps"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0][f"{tag}_{key}"],
                                       [m[key] for m in one.metrics_log],
                                       rtol=1e-4)
        _adam_params_close(ranks[0][f"{tag}_params"], one)
        del one
        torch.cuda.empty_cache()


MOE_FULL = dict(arch="qwen3-moe-30b-a3b", layers=24, steps=4, global_batch=8,
                seq_len=2048, lr=3e-4, meshes=[[1, 4]], trace=True)
MOE_FULL_RUNS = [("full", 1), ("full", 2), ("dots", 1), ("dots", 2)]


def test_nccl_4_tp_trains_qwen3_moe_full_width(cuda, tmp_path):
    """Qwen3-30B-A3B at its published widths (d_model 2048, 32/4 heads of
    128, 128 experts of 768, top-8, capacity 1.25, vocab 151936, untied)
    with 24 of its 48 layers (the depth cut: all 48 hold ~366 GB of
    training state; 24 hold ~3.9 B parameters a rank, ~47 GB with the
    AdamW moments), bf16, unrolled, AdamW, 8 x 2048 tokens a step, trained
    tensor-parallel over four NCCL ranks on (1, 4) ("data", "model"): the
    experts over "model" (32 a rank) under expert parallelism, each
    rank's 4096 tokens routed at the capacity of its 512-token blocks.
    Remat "full" and "dots", each at ``moe_a2a_chunks`` Q = 1 and 2, each
    from seed 0: a warm-up step and 3 timed steps, then one traced step.

    First the oracle: the same widths with 2 layers, float32, a capacity
    factor of E / K = 16 (nothing dropped, so expert parallelism is the
    dense dispatch of one card), 8 x 512 tokens (the sequence cut so that
    one card's forward holds the whole batch at that capacity: the aux
    loss averages its expert loads over the batch, so the reference may
    not split it), one step on (1, 4): its first loss within 1e-4 of the
    loss's scale of one card's forward of the same weights on the same
    batch. Holds for the full-width runs: the losses finite and equal on
    every rank; the first loss (the forward) the same under "full" and
    "dots" at one Q, bit for bit, and at Q = 2 within one bf16 spacing at
    the loss's magnitude of Q = 1's (the bound of
    test_nccl_4_tp_trains_qwen3_8b_full_width: the expert products run
    on Q slices of the capacity, which cuBLAS may tile otherwise); every
    card's peak under 80 GiB, the bytes at rest within 1% above the sum
    of the rank's blocks, and 6Q all-to-alls a layer a step (2Q forward,
    2Q in the recompute, 2Q backward). Prints
    one JSON line a run: step ms, tokens/s, MFU (6·N_active·tokens over 4
    x 989 TFLOP/s; N_active: 8 of the 128 experts a token, the embedding
    left out, the head counted), peak and at-rest GiB a card, all-to-alls
    a step, the share of routed assignments capacity dropped, the losses,
    and rank 0's traced NCCL time that no compute kernel overlaps."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json
    import math

    from _torch_dist import spawn, tp_full_reference

    from repro_torch.config.registry import get_arch

    oracle = dict(MOE_FULL, layers=2, steps=1, f32=True, capacity=16.0,
                  seq_len=512, trace=False, prefix="oracle_")
    specs = [oracle] + [dict(MOE_FULL, remat=r, chunks=q,
                             prefix=f"{r}{q}_") for r, q in MOE_FULL_RUNS]
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_train_full=specs),
                  None, tmp_path, 2400)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = tp_full_reference(oracle, cuda, rows=oracle["global_batch"])
    got = float(ranks[0]["oracle_m1x4_loss"][0])
    assert abs(got - ref["f32"]) <= 1e-4 * abs(ref["f32"]), (got, ref)
    print(json.dumps({"test": "tp_train_qwen3_moe_oracle", "layers": 2,
                      "f32": True, "capacity_factor": 16.0,
                      "tokens": [oracle["global_batch"], oracle["seq_len"]],
                      "first_loss_tp": got, "first_loss_one_card": ref["f32"],
                      "rel_diff": abs(got - ref["f32"]) / abs(ref["f32"]),
                      "gpu": _gpu_lines()}), flush=True)
    cfg = get_arch(MOE_FULL["arch"])
    layers = MOE_FULL["layers"]
    n_active = _moe_active(cfg, layers)
    tokens = MOE_FULL["global_batch"] * MOE_FULL["seq_len"]
    first = {(r, q): float(ranks[0][f"{r}{q}_m1x4_loss"][0])
             for r, q in MOE_FULL_RUNS}
    bound = 2.0 ** (math.floor(math.log2(first["full", 1])) - 7)
    for q in (1, 2):
        assert first["full", q] == first["dots", q], first
    assert abs(first["full", 2] - first["full", 1]) <= bound, first
    for spec in specs[1:]:
        tag = spec["prefix"] + "m1x4"
        q = spec["chunks"]
        for out in ranks:
            assert np.isfinite(out[f"{tag}_loss"]).all()
            np.testing.assert_array_equal(out[f"{tag}_loss"],
                                          ranks[0][f"{tag}_loss"])
            assert out[f"{tag}_peak_bytes"] < 80 * 2 ** 30
            rest, blocks = (int(out[f"{tag}_rest_bytes"]),
                            int(out[f"{tag}_block_bytes"]))
            assert blocks <= rest <= 1.01 * blocks, (rest, blocks)
            assert float(out[f"{tag}_a2a_per_step"]) == 6 * q * layers
        r0 = ranks[0]
        step_s = float(np.median(r0[f"{tag}_step_s"][1:]))
        print(json.dumps({
            "test": "tp_train_qwen3_moe_full_width", "mesh": [1, 4],
            "cards": 4, "gpu": _gpu_lines(),
            "layers": layers, "layers_published": cfg.num_layers,
            "remat": spec["remat"], "a2a_chunks": q,
            "init_s": float(r0[f"{tag}_init_s"]),
            "step_ms": [1e3 * x for x in r0[f"{tag}_step_s"][1:].tolist()],
            "step_ms_median": 1e3 * step_s,
            "warmup_step_ms": 1e3 * float(r0[f"{tag}_step_s"][0]),
            "tokens_per_s": tokens / step_s, "n_active": n_active,
            "mfu": 6 * n_active * tokens / step_s / (4 * 989e12),
            "peak_gib": [float(o[f"{tag}_peak_bytes"]) / 2 ** 30
                         for o in ranks],
            "rest_gib": [float(o[f"{tag}_rest_bytes"]) / 2 ** 30
                         for o in ranks],
            "block_gib": [float(o[f"{tag}_block_bytes"]) / 2 ** 30
                          for o in ranks],
            "a2a_per_step": float(r0[f"{tag}_a2a_per_step"]),
            "dropped_share": [float(o[f"{tag}_dropped_share"])
                              for o in ranks],
            "losses": r0[f"{tag}_loss"].tolist(),
            "grad_norms": r0[f"{tag}_grad_norm"].tolist(),
            "ln_vocab": math.log(cfg.vocab_size), "first_loss_bound": bound,
            "traced_step_rank0": {k: float(r0[f"{tag}_{k}"]) for k in
                                  ("traced_s", "nccl_ms", "compute_ms",
                                   "nccl_exposed_ms")},
            "host_top_rank0": json.loads(str(r0[f"{tag}_host_top"]))[:6],
        }), flush=True)


ETP_SERVE = dict(arch="mixtral-8x7b", mesh=[1, 4], layers=2, experts=6,
                 batch=8, prompt=2048, ring=4096, steps=32)
ETP_TRAIN = dict(arch="mixtral-8x7b", layers=2, experts=6, steps=2,
                 global_batch=8, seq_len=512, lr=3e-4, meshes=[[1, 4]],
                 f32=True, trace=False, prefix="etp_")


def _dryrun_peak(cfg, seq: int, batch: int, dtype, mesh_shape) -> dict:
    """``Cell.lower(mesh).compile()`` of a train cell (unrolled, remat
    "full", the all-to-alls in one slice) for rank 0 of a fake process
    group of ``prod(mesh_shape)`` ranks on ("data", "model"), in this
    process on the CPU (no card): its argument and temp bytes."""
    import math

    import torch.distributed as dist

    from repro_torch.config.base import ParallelConfig
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.model import ModelOptions

    fake_group(math.prod(mesh_shape))
    try:
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), "cpu")
        cell = build_cell(
            cfg, ShapeConfig("train", seq, batch, "train"),
            ModelOptions(dtype=dtype, scan_layers=False, remat="full"),
            ParallelConfig(remat="full", scan_layers=False))
        mem = cell.lower(mesh).compile().memory_analysis()
    finally:
        dist.destroy_process_group()
    return {"argument_gib": mem.argument_size_in_bytes / 2 ** 30,
            "temp_gib": mem.temp_size_in_bytes / 2 ** 30,
            "estimate_gib": mem.peak_bytes / 2 ** 30}


TP_2X2 = dict(arch="qwen3-8b", steps=4, global_batch=8, seq_len=2048,
              lr=3e-4, meshes=[[2, 2]], trace=False)


def test_nccl_4_tp_qwen3_8b_2x2_gathers_per_layer(cuda, tmp_path):
    """Qwen3-8B at its published widths (36 layers, bf16, unrolled, remat
    "full", 8 x 2048 tokens a step) trained tensor-parallel on (2, 2)
    ("data", "model") over four NCCL ranks four times, each from seed 0,
    in the order A B B A: A with every leaf's data blocks gathered at the
    top of the step and the whole-block gradients taken back through the
    gathers once (the schedule the per-layer gathers replaced,
    ``analysis.lint_targets.gather_all_tp_step``), B with the step as it
    is (each layer's blocks gathered inside its remat region). A warm-up
    step and 3 timed steps each; the first B run then logs one more
    step's issue order (``analysis.comm_log.record``) and lints it
    (``tp_train_ctx``: no sends, the state updated in place, at most two
    layers' data gathers live at once). Holds: the losses equal on every
    rank and in every run of a schedule, the first loss (the forward)
    bit-equal between the two schedules, the per-layer step's peak below
    the gather-all's, the lint clean on every rank, and the dry run's
    estimate of the per-layer cell (``Cell.lower`` on a fake group of 4,
    this process's CPU) within 10% of the measured peak of the last
    timed step. Prints one JSON line: each run's step ms and peak GiB,
    the estimate and the lint."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json

    from _torch_dist import spawn

    from repro_torch.config.registry import get_arch

    runs = [("ga_", True), ("pl_", False), ("pl2_", False), ("ga2_", True)]
    specs = [dict(TP_2X2, prefix=p, gather_all=g, lint=p == "pl_")
             for p, g in runs]
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_train_full=specs),
                  None, tmp_path, 1500)
    tags = [p + "m2x2" for p, _ in runs]
    for tag in tags:
        for out in ranks:
            assert np.isfinite(out[f"{tag}_loss"]).all()
            np.testing.assert_array_equal(out[f"{tag}_loss"],
                                          ranks[0][f"{tag}_loss"])
            assert out[f"{tag}_peak_bytes"] < 80 * 2 ** 30
    r0 = ranks[0]
    for a, b in (("ga_m2x2", "ga2_m2x2"), ("pl_m2x2", "pl2_m2x2")):
        np.testing.assert_array_equal(r0[f"{a}_loss"], r0[f"{b}_loss"])
    assert r0["ga_m2x2_loss"][0] == r0["pl_m2x2_loss"][0]
    for out in ranks:
        assert bool(out["pl_m2x2_lint_ok"]), str(out["pl_m2x2_lint"])
        for ga, pl in (("ga_m2x2", "pl_m2x2"), ("ga2_m2x2", "pl2_m2x2")):
            assert out[f"{pl}_step_peak"] < out[f"{ga}_step_peak"]
    est = _dryrun_peak(get_arch("qwen3-8b"), TP_2X2["seq_len"],
                       TP_2X2["global_batch"], torch.bfloat16, (2, 2))
    peak_gib = max(float(o["pl_m2x2_step_peak"]) for o in ranks) / 2 ** 30
    err = est["estimate_gib"] / peak_gib - 1
    report = json.loads(str(r0["pl_m2x2_lint"]))
    print(json.dumps({
        "test": "tp_qwen3_8b_2x2_gathers_per_layer", "mesh": [2, 2],
        "cards": 4, "gpu": _gpu_lines(),
        "order": [t.split("_")[0] for t in tags],
        "step_ms": {t: [1e3 * x for x in r0[f"{t}_step_s"][1:].tolist()]
                    for t in tags},
        "step_ms_median": {t: 1e3 * float(np.median(r0[f"{t}_step_s"][1:]))
                           for t in tags},
        "step_peak_gib": {t: [float(o[f"{t}_step_peak"]) / 2 ** 30
                              for o in ranks] for t in tags},
        "rest_gib": [float(o["pl_m2x2_rest_bytes"]) / 2 ** 30
                     for o in ranks],
        "losses": {"gather_all": r0["ga_m2x2_loss"].tolist(),
                   "per_layer": r0["pl_m2x2_loss"].tolist()},
        "dryrun": est, "dryrun_rel_err": err,
        "lint": {"ok": report["ok"], "events": int(r0["pl_m2x2_lint_events"]),
                 "collectives": report["n_collectives"]},
    }), flush=True)
    assert abs(err) <= 0.10, (est, peak_gib)


LINT_STEPS = dict(arch="qwen3-8b", layers=8, steps=2, global_batch=8,
                  seq_len=1024, lr=3e-4, bf16=True, slots=8, max_len=256)
LINT_MOE = dict(arch="qwen3-moe-30b-a3b", layers=4, steps=1,
                global_batch=8, seq_len=1024, lr=3e-4, meshes=[[1, 4]],
                chunks=2, trace=False, lint=True, prefix="moe_")


def test_nccl_4_lints_real_logs(cuda, tmp_path):
    """The schedule linter on the real issue order of four NCCL ranks, one
    card each: one logged step each of streaming ZeRO-3 (Qwen3-8B at its
    widths, 8 of its 36 layers, bf16, (4,) "data"), the TP decode step
    (the same model, (1, 4), 8 slots) and the TP train step of a MoE model
    under expert parallelism with ``a2a_scan`` at Q = 2 (Qwen3-30B-A3B at
    its widths, 4 of its 48 layers, (1, 4)); the dense TP train step is
    linted in ``test_nccl_4_tp_qwen3_8b_2x2_gathers_per_layer``. Each
    rank's log lints clean under the expectations the CPU targets use
    (``analysis.lint_targets``: ``streaming_ctx``, ``decode_ctx``,
    ``tp_train_ctx``). Prints one JSON line: each log's length,
    collectives and findings on rank 0."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json

    from _torch_dist import spawn

    ranks = spawn(dict(mesh=[4], backend="nccl", lint_steps=LINT_STEPS,
                       tp_train_full=[LINT_MOE]), None, tmp_path, 900)
    reports = {}
    for tag in ("zero3", "decode", "moe_m1x4"):
        for out in ranks:
            assert bool(out[f"{tag}_lint_ok"]), str(out[f"{tag}_lint"])
        rep = json.loads(str(ranks[0][f"{tag}_lint"]))
        reports[tag] = {"events": int(ranks[0][f"{tag}_lint_events"]),
                        "collectives": rep["n_collectives"],
                        "findings": rep["findings"]}
    print(json.dumps({"test": "lints_real_logs", "cards": 4,
                      "gpu": _gpu_lines(), "torch": torch.__version__,
                      "logs_rank0": reports}), flush=True)


def test_nccl_4_expert_tp_mixtral_full_width(cuda, tmp_path):
    """Expert TP on four NCCL ranks at (1, 4) ("data", "model"): Mixtral-8x7B
    at its published widths (d_model 4096, 32/8 heads of 128, top-2
    experts of d_ff 14336, vocab 32000, window 4096) with two cuts, the
    experts from 8 to 6 (so that the 4 ranks do not divide them: the rules
    replicate the experts and split their columns) and the depth from 32
    layers to 2.

    Served (bf16, unrolled, each leaf drawn from seed 0 and cut before the
    next): 8 prompts of 2048 tokens into 4096-slot rings, then 32
    teacher-forced decode steps; every step's gathered logits against the
    same parameters whole on each rank's own card (``model.prefill`` /
    ``decode_step``) within the bf16 bounds of two full-width runs (mean
    0.1, max 1.0); each rank holds all 6 experts, its blocks' shapes, and
    at rest the bytes of its blocks within 1%. Trained (f32, remat
    "full", 8 x 512 tokens, 2 steps): the first loss within 1e-4 of the
    loss's scale of one card's forward of the same weights on the same
    batch; the losses finite and equal on every rank; at rest within 1%
    above the blocks.

    Then the dry run (``Cell.lower``, fake groups, on the CPU of this
    process) of that training cell beside rank 0's measured step peak,
    and of the test_nccl_4_tp_trains_qwen3_moe_full_width cell
    (Qwen3-30B-A3B, 24 layers, bf16, 8 x 2048 tokens, (1, 4)) beside the
    peak that test measured (50.36 GiB a card, init included, on an
    NVIDIA H100 80GB HBM3 at 700 W). Prints one JSON line."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import dataclasses
    import json

    from _torch_dist import spawn, tp_full_reference

    from repro_torch.config.registry import get_arch

    ranks = spawn(dict(mesh=[4], backend="nccl", expert_tp_full=ETP_SERVE,
                       tp_train_full=[ETP_TRAIN]), None, tmp_path, 1500)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = tp_full_reference(ETP_TRAIN, cuda, rows=ETP_TRAIN["global_batch"])
    tag = "etp_m1x4"
    got = float(ranks[0][f"{tag}_loss"][0])
    assert abs(got - ref["f32"]) <= 1e-4 * abs(ref["f32"]), (got, ref)
    for r, out in enumerate(ranks):
        assert out["experts_placed"].tolist() == [False, True, False, True]
        assert (out["expert_leaf_experts"] == ETP_SERVE["experts"]).all()
        assert bool(out["param_blocks_ok"]) and bool(out["finite"])
        rest, blocks = int(out["params_at_rest"]), int(out["params_blocks"])
        assert blocks <= rest <= 1.01 * blocks, (r, rest, blocks)
        assert float(out["logit_mean_abs"].max()) <= 0.1, r
        assert float(out["logit_max_abs"].max()) <= 1.0, r
        np.testing.assert_array_equal(out[f"{tag}_loss"],
                                      ranks[0][f"{tag}_loss"])
        assert np.isfinite(out[f"{tag}_loss"]).all()
        rest, blocks = (int(out[f"{tag}_rest_bytes"]),
                        int(out[f"{tag}_block_bytes"]))
        assert blocks <= rest <= 1.01 * blocks, (r, rest, blocks)
    mixtral = get_arch("mixtral-8x7b")
    etp_cfg = dataclasses.replace(mixtral, num_layers=2, moe=dataclasses
                                  .replace(mixtral.moe, num_experts=6))
    etp = _dryrun_peak(etp_cfg, ETP_TRAIN["seq_len"],
                       ETP_TRAIN["global_batch"], torch.float32, [1, 4])
    r0 = ranks[0]
    etp["measured_step_peak_gib"] = float(r0[f"{tag}_step_peak"]) / 2 ** 30
    etp["measured_held_gib"] = float(r0[f"{tag}_step_held"]) / 2 ** 30
    qwen = _dryrun_peak(dataclasses.replace(
        get_arch(MOE_FULL["arch"]), num_layers=MOE_FULL["layers"]),
        MOE_FULL["seq_len"], MOE_FULL["global_batch"], torch.bfloat16,
        [1, 4])
    qwen["measured_peak_gib_qwen3_moe_test"] = 50.36
    print(json.dumps({
        "test": "expert_tp_mixtral_full_width", "mesh": [1, 4],
        "cards": 4, "gpu": _gpu_lines(), "layers": 2,
        "layers_published": mixtral.num_layers, "experts": 6,
        "experts_published": mixtral.moe.num_experts,
        "serve_logit_mean_abs": [float(o["logit_mean_abs"].max())
                                 for o in ranks],
        "serve_logit_max_abs": [float(o["logit_max_abs"].max())
                                for o in ranks],
        "params_at_rest_gib": [float(o["params_at_rest"]) / 2 ** 30
                               for o in ranks],
        "param_blocks_gib": float(r0["params_blocks"]) / 2 ** 30,
        "first_loss_tp": got, "first_loss_one_card": ref["f32"],
        "rel_diff": abs(got - ref["f32"]) / abs(ref["f32"]),
        "losses": r0[f"{tag}_loss"].tolist(),
        "train_rest_gib": [float(o[f"{tag}_rest_bytes"]) / 2 ** 30
                           for o in ranks],
        "train_step_ms": [1e3 * x for x in r0[f"{tag}_step_s"].tolist()],
        "dryrun_expert_tp_train": etp,
        "dryrun_qwen3_moe_24_layers": qwen}), flush=True)
    assert abs(etp["estimate_gib"] / etp["measured_step_peak_gib"] - 1) \
        <= 0.15, etp


def _moe_active(cfg, layers: int) -> int:
    """N_active of `cfg` cut to `layers` layers: the parameters a token's
    forward multiplies, 8 of the 128 experts counted, the embedding
    lookup left out, the untied head counted."""
    import dataclasses

    cut = dataclasses.replace(cfg, num_layers=layers)
    return cut.active_params() - cut.vocab_size * cut.d_model


def test_nccl_4_tp_mamba2_2x2_step_host_profile(cuda, tmp_path):
    """Mamba-2 780M at its published widths trained tensor-parallel on a
    (2, 2) ("data", "model") mesh over four NCCL ranks (as in
    test_nccl_4_tp_trains_recurrent_families_full_width, which found its
    step at 1135 ms against 412 ms of traced device work): a warm-up and
    2 timed steps, then one traced step on every rank with its host
    profile (the host ops with the most self time, the CUDA runtime calls
    made 32 times or more). Holds the losses finite and equal on every
    rank; prints one JSON line."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json

    from _torch_dist import spawn

    spec = dict(arch="mamba2-780m", scan=True, steps=3, global_batch=8,
                seq_len=2048, lr=3e-4, meshes=[[2, 2]], trace=True)
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_train_full=spec), None,
                  tmp_path, 900)
    for out in ranks:
        assert np.isfinite(out["m2x2_loss"]).all()
        np.testing.assert_array_equal(out["m2x2_loss"],
                                      ranks[0]["m2x2_loss"])
    print(json.dumps({
        "test": "tp_mamba2_2x2_host_profile", "gpu": _gpu_lines(),
        "step_ms": [1e3 * x for x in ranks[0]["m2x2_step_s"][1:].tolist()],
        "ranks": [{
            "traced_s": float(o["m2x2_traced_s"]),
            **{k: float(o[f"m2x2_{k}"]) for k in
               ("nccl_ms", "compute_ms", "nccl_exposed_ms")},
            "host_top": json.loads(str(o["m2x2_host_top"])),
            "runtime_calls": json.loads(str(o["m2x2_runtime_calls"]))}
            for o in ranks]}), flush=True)


TP_RANK_SCANS = [  # the blocks a rank of the 4-card runs gives each scan
    ("ssd", (8, 2048, 12, 64, 128)), ("ssd", (4, 2048, 24, 64, 128)),
    ("lru", (8, 2048, 640)), ("lru", (4, 2048, 1280))]


@pytest.mark.parametrize("kind,shape", TP_RANK_SCANS)
def test_scans_launch_kernels_at_tp_rank_shapes(cuda, kind, shape):
    """At the rank-local shapes of the 4-card TP runs (Mamba-2's SSD at
    bf16, chunk 256; the RG-LRU at f32), a wrapper call under autograd on
    the card launches its forward kernel once and its backward kernel
    once, calls no plain version, and agrees with autograd of the plain
    version on the same inputs and cotangents: the SSD within 5e-2 (bf16)
    and the LRU within 1e-5 of each output's or gradient's largest
    magnitude (the forward's tolerances)."""
    from _torch_dist import plain_scans_counted

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    if kind == "ssd":
        import torch.nn.functional as F

        b, l, h, p, n = shape
        x = torch.randn((b, l, h, p), generator=gen,
                        device=cuda).to(torch.bfloat16)
        dt = F.softplus(torch.randn((b, l, h), generator=gen, device=cuda))
        A = -torch.exp(0.2 * torch.randn((h,), generator=gen, device=cuda))
        B, C = (torch.randn((b, l, n), generator=gen,
                            device=cuda).to(torch.bfloat16) for _ in "BC")
        leaves = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
        cots = (torch.randn((b, l, h, p), generator=gen,
                            device=cuda).to(torch.bfloat16),
                torch.randn((b, h, p, n), generator=gen, device=cuda))
        wrapper, tol = ssd_ops.ssd, 5e-2

        def call(impl):
            return ssd_ops.ssd(*leaves, 256, impl=impl)
    else:
        b, l, w = shape
        a = (0.5 + 0.49 * torch.rand((b, l, w), generator=gen,
                                     device=cuda)).requires_grad_(True)
        xb = torch.randn((b, l, w), generator=gen,
                         device=cuda).requires_grad_(True)
        leaves = [a, xb]
        cots = (torch.randn((b, l, w), generator=gen, device=cuda),
                torch.randn((b, w), generator=gen, device=cuda))
        wrapper, tol = lru_ops.lru_scan, 1e-5

        def call(impl):
            return lru_ops.lru_scan(a, xb, impl=impl)
    before = (wrapper.launches, wrapper.bwd_launches)
    with plain_scans_counted() as plain:
        outs = call("auto")
        grads = torch.autograd.grad(outs, leaves, cots)
        torch.cuda.synchronize()
    assert (wrapper.launches - before[0],
            wrapper.bwd_launches - before[1]) == (1, 1)
    assert plain == {"lru_scan_ref": 0, "ssd_chunk_terms": 0}
    want_outs = call("plain")
    want = torch.autograd.grad(want_outs, leaves, cots)
    for g, w_ in zip((*outs, *grads), (*want_outs, *want)):
        g, w_ = g.detach(), w_.detach()
        assert bool(torch.isfinite(g).all())
        assert _rel_err(g, w_) <= tol


def test_nccl_4_tp_decode_serves_qwen3_8b_full_width(cuda, tmp_path):
    """Qwen3-8B at its published widths (36 layers, d_model 4096, 32/8
    heads of 128, d_ff 12288, vocab 151936; random bf16 weights from seed
    0, replicated on every card) served by run_continuous over four NCCL
    ranks, one card each, through the TP decode step on the ("data",
    "model") meshes (1, 4) and (2, 2), under hdot and two_phase; chip_smoke
    .py phase 8's traffic (16 requests, prompts uniform in 128-2048 tokens
    from numpy seed 0, 64 new tokens each, 8 slots, max_len 2176, greedy).
    Every rank first serves the same traffic alone (model.decode_step).

    Holds, for each mesh and mode: every request gets its 64 tokens; the
    sends a decode step equal expected_permute_total (two_phase none); the
    flash kernel launched 36 times a prefill; on every rank, a
    teacher-forced first decode step after identical admissions within
    the bf16 logit bounds (mean 0.1, max 1.0) of that rank's own
    model.decode_step; every card's peak under 80 GiB. Every rank serves
    rank 0's ids by construction (the server broadcasts them), so what is
    reported instead is how many ids each rank had chosen otherwise before
    the broadcast. Prints one JSON line per run: the cards' names and
    power limits (nvidia-smi), output tokens/s, the median decode-step ms,
    the peak GiB of each card, the sends a step, the ids each rank chose
    otherwise than rank 0, rank 0's traced decode step (its wall time,
    NCCL time, the NCCL time no compute overlaps, the share hidden, the
    device's idle share, the host ops with the most self time), and,
    reported, not held (the rings reassociate bf16 sums), the share of
    tokens equal to the one-card server's and to the other mode's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json
    import statistics

    from _torch_dist import spawn

    from repro_torch.config.registry import get_arch
    from repro_torch.models.decode_tp import expected_permute_total

    spec = dict(arch="qwen3-8b", requests=16, new_tokens=64, slots=8,
                max_len=2176, meshes=[[1, 4], [2, 2]],
                modes=["hdot", "two_phase"])
    ranks = spawn(dict(mesh=[4], backend="nccl", tp_full=spec), None,
                  tmp_path, 1500)
    cfg = get_arch("qwen3-8b")
    gpu = _gpu_lines()
    r0 = ranks[0]
    tags = ["one"] + [f"{dp}x{tp}_{mode}" for dp, tp in spec["meshes"]
                      for mode in spec["modes"]]
    for tag in tags:
        toks = r0[f"{tag}_tokens"]
        assert (toks >= 0).all() and (toks < cfg.vocab_size).all(), tag
        for out in ranks:
            assert out[f"{tag}_peak_bytes"] < 80 * 2 ** 30
        prefills = int(r0[f"{tag}_prefills"])
        assert int(r0[f"{tag}_flash"]) == 36 * prefills, tag
        step_s = r0[f"{tag}_step_s"]
        row = {"test": "tp_decode_qwen3_8b_full_width", "run": tag,
               "cards": 1 if tag == "one" else 4, "gpu": gpu,
               "output_tokens_per_s": toks.size / float(r0[f"{tag}_wall_s"]),
               "wall_s": float(r0[f"{tag}_wall_s"]),
               "decode_steps": len(step_s),
               "decode_step_ms_median": 1e3 * statistics.median(step_s),
               "prefills": prefills, "flash_launches": int(r0[f"{tag}_flash"]),
               "peak_gib": [float(o[f"{tag}_peak_bytes"]) / 2 ** 30
                            for o in ranks]}
        if tag != "one":
            mesh_tag, mode = tag.split("_", 1)
            dp, tp = map(int, mesh_tag.split("x"))
            sends = int(r0[f"{tag}_sends"])
            assert sends == (expected_permute_total(cfg, spec["slots"], dp,
                                                    tp) * len(step_s)
                             if mode == "hdot" else 0), (tag, sends)
            forced = [{k: float(out[f"{tag}_forced_{k}"])
                       for k in ("mean_abs", "max_abs")} for out in ranks]
            for r, f in enumerate(forced):
                assert f["mean_abs"] <= 0.1 and f["max_abs"] <= 1.0, \
                    (tag, r, f)
            other = mesh_tag + ("_two_phase" if mode == "hdot" else "_hdot")
            nccl = float(r0[f"{tag}_nccl_ms"])
            exposed = float(r0[f"{tag}_nccl_exposed_ms"])
            compute = float(r0[f"{tag}_compute_ms"])
            wall = 1e3 * float(r0[f"{tag}_traced_s"])
            row.update(
                sends_per_step=sends / len(step_s),
                ids_off_rank0=[int(out[f"{tag}_ids_off_rank0"])
                               for out in ranks],
                teacher_forced_vs_decode_step=forced,
                traced_step_rank0={
                    "wall_ms": wall, "nccl_ms": nccl, "compute_ms": compute,
                    "nccl_exposed_ms": exposed,
                    "nccl_hidden_share": (nccl - exposed) / nccl
                    if nccl else None,
                    "device_idle_share": 1 - (compute + exposed) / wall,
                    "host_top_self_ms": json.loads(
                        str(r0[f"{tag}_host_top"]))},
                tokens_equal_one_card=float((toks == r0["one_tokens"]).mean()),
                tokens_equal_other_mode=float(
                    (toks == r0[f"{other}_tokens"]).mean()))
        print(json.dumps(row))


SERVE_FAMILIES = {"dense": "qwen3-8b", "moe": "mixtral-8x7b",
                  "ssm": "mamba2-780m", "hybrid": "recurrentgemma-2b",
                  "encdec": "whisper-base", "vlm": "llava-next-34b"}


def test_nccl_2x2_serve_cells_match_one_card(cuda, tmp_path):
    """The prefill and decode cells (``build_cell``, ``cell_step``) of every
    family's reduced model, float32, over four NCCL ranks on a (2, 2)
    ("data", "model") mesh, each rank holding its blocks under
    ``rules_for(kind)`` (the caches and parameters re-laid between the
    cells): 2 prompts of 12 tokens into 16-slot rings, 8 teacher-forced
    decode steps past the wrap (``tests/_torch_serve.py``). On every
    rank the gathered logits match ``model.prefill`` / ``decode_step`` on
    its own card at rtol 1e-4 (atol 1e-4), and every leaf it holds is its
    block. The gloo version against the JAX package is
    ``tests/test_torch_serve_cells.py``."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from _torch_dist import spawn

    from repro_torch.config.registry import get_arch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions, build_model

    cases = []
    for fam, arch in SERVE_FAMILIES.items():
        case = dict(tag=fam, arch=arch, factor=4.0 if fam == "moe" else None)
        cfg = get_arch(arch).reduced()
        if case["factor"]:
            import dataclasses
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=case["factor"]))
        p = build_model(cfg, ModelOptions(dtype=torch.float32,
                                          scan_layers=False)).init(0, "cpu")
        np.savez(tmp_path / f"{fam}.npz",
                 **{f"leaf{i}": t.numpy() for i, t in
                    enumerate(tree_leaves(p))})
        cases.append(case)
    spec = dict(mesh=[2, 2], axes=["data", "model"], cases=cases, one=True)
    ranks = spawn(dict(mesh=[4], backend="nccl", serve_cells=spec), None,
                  tmp_path, 300)
    for fam in SERVE_FAMILIES:
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out[f"{fam}_logits"],
                                       out[f"{fam}_one"], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{fam} rank {r}")
            assert out[f"{fam}_param_blocks_ok"], (fam, r)
            assert out[f"{fam}_cache_blocks_ok"], (fam, r)


SERVE_FULL = dict(arch="mixtral-8x7b", mesh=[1, 4], batch=8, prompt=3968,
                  ring=4096, steps=256, check=True, check_prompt=1000,
                  check_ring=1024, check_steps=32, check_factor=4.0)


def test_nccl_4_serve_cells_mixtral_8x7b_full_width(cuda, tmp_path):
    """Mixtral-8x7B at its published widths (32 layers, d_model 4096, 32/8
    heads of 128, 8 experts top-2 of d_ff 14336, vocab 32000, window
    4096; 46.7 B parameters, 87 GiB in bf16, which no card holds) served
    through the prefill and decode cells over four NCCL ranks on a
    (1, 4) ("data", "model") mesh: bf16, unrolled, each leaf drawn from
    seed 0 and cut before the next; 8 prompts of 3968 tokens into
    4096-slot rings, then 256 greedy decode steps at a scalar position
    (the ring wraps by 128). At (1, 4) the two cells' blocks coincide for
    every parameter and cache leaf (asserted: nothing moves between
    them), each rank holds 2 of the 8 experts and a quarter of every
    other large leaf.

    Holds: GiB at rest within 1% of the rank's blocks (parameters and
    caches); the flash kernel launched 32 times a prefill on every rank
    (on its 8 query and 2 KV heads); every decode step one sharded
    flash-decode a layer and 2 all-to-alls a layer (the experts' dispatch
    and combine over the batch); the ids finite and in range. First, the
    oracle: a 2-layer cut at the same widths in float32 (its capacity
    factor 4, so that expert parallelism's per-rank capacity drops
    nothing, as the reduced tests do) through the same cells against
    ``model.prefill`` / ``decode_step`` on each rank's own card with the
    same parameters (1000-token prompts, 1024-slot rings, 32 steps past
    the wrap): the largest logit difference within 1e-3; and the sharded
    flash-decode alone against ``_decode_dense`` over the gathered ring on
    the same ranks (2e-4). Prints one JSON line: the cards' names and
    power limits, GiB at rest and blocks, the peak a card (init included),
    prefill tokens/s, decode ms a step (median), the collectives a step,
    flash launches a rank, one traced decode step on rank 0 (NCCL ms, the
    part no compute overlaps)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    import json
    import statistics

    from _torch_dist import spawn

    ranks = spawn(dict(mesh=[4], backend="nccl", serve_full=SERVE_FULL,
                       flash_decode={"windows": [None, 32]}), None,
                  tmp_path, 780)
    gpu = _gpu_lines()
    layers, vocab = 32, 32000
    for r, out in enumerate(ranks):
        assert float(out["check_max_abs"].max()) <= 1e-3, (r, out[
            "check_max_abs"])
        for w in (None, 32):
            assert float(out[f"fd_w{w}_vs_dense"]) < 2e-4, (r, w)
        assert out["param_blocks_coincide"] and out["cache_blocks_coincide"]
        rest = float(out["params_at_rest"]) + float(out["caches_at_rest"])
        blocks = float(out["params_blocks"]) + float(out["cache_blocks"])
        assert abs(rest - blocks) <= 0.01 * blocks, (r, rest, blocks)
        assert int(out["flash"]) == layers, (r, int(out["flash"]))
        steps = len(out["step_s"])
        assert int(out["flash_decode_calls"]) == layers * steps
        assert int(out["decode_a2a"]) == 2 * layers * steps
        assert bool(out["finite"])
        assert ((out["ids"] >= 0) & (out["ids"] < vocab)).all()
    r0 = ranks[0]
    step_s = r0["step_s"]
    nccl, exposed = float(r0["nccl_ms"]), float(r0["nccl_exposed_ms"])
    print(json.dumps({
        "test": "serve_cells_mixtral_8x7b_full_width", "mesh": [1, 4],
        "gpu": gpu,
        "gib_at_rest": [(float(o["params_at_rest"])
                         + float(o["caches_at_rest"])) / 2**30
                        for o in ranks],
        "gib_params_at_rest": [float(o["params_at_rest"]) / 2**30
                               for o in ranks],
        "gib_param_blocks": float(r0["params_blocks"]) / 2**30,
        "gib_caches_at_rest": [float(o["caches_at_rest"]) / 2**30
                               for o in ranks],
        "gib_cache_blocks": float(r0["cache_blocks"]) / 2**30,
        "peak_gib": [float(o["peak"]) / 2**30 for o in ranks],
        "init_peak_gib": [float(o["init_peak"]) / 2**30 for o in ranks],
        "init_s": float(r0["init_s"]),
        "prefill_s": float(r0["prefill_s"]),
        "prefill_tokens_per_s": SERVE_FULL["batch"] * SERVE_FULL["prompt"]
        / float(r0["prefill_s"]),
        "decode_steps": len(step_s),
        "decode_ms_median": 1e3 * statistics.median(step_s),
        "decode_ms_min": 1e3 * float(min(step_s)),
        "a2a_prefill": int(r0["prefill_a2a"]),
        "a2a_per_step": int(r0["decode_a2a"]) / len(step_s),
        "flash_decode_allreduces_per_step":
            3 * int(r0["flash_decode_calls"]) / len(step_s),
        "flash_launches_per_rank": [int(o["flash"]) for o in ranks],
        "check_max_abs": float(max(o["check_max_abs"].max()
                                   for o in ranks)),
        "check_logit_scale": float(r0["check_logit_scale"]),
        "flash_decode_vs_dense": float(max(
            float(o[f"fd_w{w}_vs_dense"]) for o in ranks
            for w in (None, 32))),
        "traced_step_rank0": {
            "wall_ms": 1e3 * float(r0["traced_s"]), "nccl_ms": nccl,
            "compute_ms": float(r0["compute_ms"]),
            "nccl_exposed_ms": exposed,
            "device_idle_share": 1 - (float(r0["compute_ms"]) + exposed)
            / (1e3 * float(r0["traced_s"])),
            "host_top_self_ms": json.loads(str(r0["host_top"])),
            "runtime_calls": json.loads(str(r0["runtime_calls"]))}}))


FLASH_CASES = [  # (b, sq, sk, hq, hkv, d, causal, window)
    (1, 1, 1, 4, 4, 64, True, None),           # one query, one key
    (2, 63, 63, 8, 2, 64, True, None),         # ragged, GQA 4:1
    (1, 1000, 1000, 32, 8, 128, True, None),   # ragged admission prefill
    (1, 1000, 1000, 32, 1, 128, True, 256),    # MQA 32:1, window
    (2, 63, 130, 4, 4, 128, False, None),      # sq < sk, bidirectional
    (1, 130, 63, 8, 2, 32, True, None),        # sq > sk, head dim 32
    (1, 16, 8, 2, 1, 64, False, 4),            # rows that see no key
    (1, 1, 70, 8, 2, 128, False, None),        # one query over 70 keys
    (1, 300, 300, 10, 1, 256, True, 128),      # head dim 256, MQA, window
    (2, 70, 70, 4, 2, 256, True, None),        # head dim 256, ragged
]
# the bf16 kernel's edges: 128-row query tiles, key tiles of 128 (head dim
# 256: 64), TMA boxes past the end of q and k
FLASH_BF16_CASES = [
    (1, 129, 129, 8, 2, 128, True, None),      # one row past a query tile
    (2, 191, 191, 4, 1, 128, False, None),     # ragged q and key tiles
    (1, 200, 50, 8, 2, 128, True, None),       # sk < one key tile, sq > sk
    (1, 300, 40, 4, 4, 256, False, 16),        # the same at head dim 256
    (8, 2048, 2048, 32, 8, 128, True, None),   # Qwen3-8B wave prefill
    (1, 700, 700, 10, 1, 256, True, 100),      # window ends inside a tile
    (2, 300, 300, 8, 2, 32, True, None),       # head dim 32 (64-byte rows)
    (2, 300, 300, 8, 2, 32, False, None),
    (1, 257, 257, 4, 4, 64, True, None),       # head dim 64
    (1, 257, 257, 4, 4, 64, False, None),
    (8, 1500, 1500, 8, 8, 64, True, None),     # Whisper-base encoder
    (8, 4, 4, 8, 8, 64, True, None),           # its 4-token decoder prefill
    (4, 1088, 1088, 56, 8, 128, True, None),   # LLaVA-NeXT-34B, GQA group 7
    (1, 300, 300, 14, 2, 128, True, None),     # group 7, ragged tiles
]


@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,causal,window,dtype",
    [c + (dt,) for c in FLASH_CASES
     for dt in (torch.bfloat16, torch.float32)]
    + [c + (torch.bfloat16,) for c in FLASH_BF16_CASES])
def test_flash_kernel_matches_plain(cuda, b, sq, sk, hq, hkv, d, causal,
                                    window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + sk)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    before = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, causal, window, "kernel")
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    want = flash_ops.flash_attention(q, k, v, causal, window, "plain")
    assert flash_ops.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_needs_a_cuda_tensor():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_ops.flash_attention(q, q, q, impl="kernel")


def test_served_on_card_equals_cpu(cuda):
    """The reduced qwen3-8b (float32, flash attention) served continuously
    on the card gives the CPU's greedy tokens, its prefill logits within
    1e-4, and one kernel launch per layer per prefill."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import BatchServer, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3-8b").reduced()
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.float32))
    params = model.init(0, "cpu")
    prompts = [[5, 9, 3, 200, 17], [7, 1], list(range(1, 70)), [11] * 33]
    outs, logits = {}, {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        logits[str(dev)] = model.prefill(
            p, {"tokens": torch.tensor([prompts[2]], device=dev)})[0].cpu()
        srv = BatchServer(model, p, slots=3, max_len=96)
        for pr in prompts:
            srv.submit(Request(prompt=list(pr), max_new_tokens=8))
        before = flash_ops.flash_attention.launches
        served = srv.run_continuous()
        launched = flash_ops.flash_attention.launches - before
        assert launched == (cfg.num_layers * srv.stats["prefills"]
                            if dev != "cpu" else 0)
        outs[str(dev)] = {r.rid: r.output for r in served}
    assert outs["cpu"] == outs[str(cuda)]
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_frontend_families_on_card_equal_cpu(cuda, arch):
    """The reduced encoder-decoder and VLM (float32, flash attention, the
    stub frames or patches in the batch): the prefill and 3 decode steps
    on the card give the CPU's logits within 1e-4, with one flash launch
    per attention layer (Whisper's encoder layers too) per prefill and
    none in decode."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.float32))
    params = model.init(0, "cpu")
    rng = np.random.default_rng(0)
    key, n = (("frames", cfg.encdec.enc_seq) if cfg.family == "encdec"
              else ("patches", cfg.num_vision_patches))
    batch = {"tokens": torch.from_numpy(rng.integers(1, 256, (2, 9))),
             key: torch.from_numpy((rng.standard_normal(
                 (2, n, cfg.d_model)) * 0.02).astype(np.float32))}
    start = 6 + (n if key == "patches" else 0)
    per_prefill = cfg.num_layers + (cfg.encdec.enc_layers
                                    if key == "frames" else 0)
    out = {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        before = flash_ops.flash_attention.launches
        logits, caches = model.prefill(
            p, {"tokens": b["tokens"][:, :6], key: b[key]}, max_len=start + 3)
        launched = flash_ops.flash_attention.launches - before
        got = [logits.cpu()]
        for i in range(3):
            logits, caches = model.decode_step(
                p, b["tokens"][:, 6 + i:7 + i], caches, start + i)
            got.append(logits.cpu())
        assert flash_ops.flash_attention.launches - before == launched == (
            per_prefill if dev != "cpu" else 0)
        out[str(dev)] = torch.cat(got, 1)
    torch.testing.assert_close(out[str(cuda)], out["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_moe_served_on_card_equals_cpu(cuda):
    """Reduced Qwen3-MoE (float32, flash attention; 4 experts, top-2,
    capacity factor 1.25, so prefills drop tokens): the MoE block on the
    card routes as the CPU does and gives its output within 1e-5 of the
    largest entry; served continuously, the card gives the CPU's greedy
    tokens, its prefill logits within 1e-4, and one flash launch per layer
    per prefill."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models import moe
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import BatchServer, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.float32))
    params = model.init(0, "cpu")
    blk = {k: v[0] for k, v in
           {**params["layers"]["moe"]._parameters}.items()}
    x = torch.randn((3, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    routes, ys = [], []
    for dev in ("cpu", cuda):
        pb = {k: v.to(dev) for k, v in blk.items()}
        routes.append(moe._route(x.to(dev), pb["router"],
                                 cfg.moe.top_k)[2].cpu())
        ys.append(moe.moe_apply_dense(pb, x.to(dev), cfg)[0].cpu())
    assert torch.equal(routes[0], routes[1])
    torch.testing.assert_close(ys[1], ys[0], rtol=0,
                               atol=1e-5 * float(ys[0].abs().max()))
    prompts = [[5, 9, 3, 200, 17], [7, 1], list(range(1, 70)), [11] * 33]
    outs, logits = {}, {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        logits[str(dev)] = model.prefill(
            p, {"tokens": torch.tensor([prompts[2]], device=dev)})[0].cpu()
        srv = BatchServer(model, p, slots=3, max_len=96)
        for pr in prompts:
            srv.submit(Request(prompt=list(pr), max_new_tokens=8))
        before = flash_ops.flash_attention.launches
        served = srv.run_continuous()
        launched = flash_ops.flash_attention.launches - before
        assert launched == (cfg.num_layers * srv.stats["prefills"]
                            if dev != "cpu" else 0)
        outs[str(dev)] = {r.rid: r.output for r in served}
    assert outs["cpu"] == outs[str(cuda)]
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


LRU_CASES = [  # (b, l, w, a dtype, b dtype, h0)
    (1, 1, 5, torch.float32, torch.float32, True),        # length 1
    (3, 77, 100, torch.float32, torch.float32, True),     # width % 32 != 0
    (2, 513, 64, torch.float32, torch.bfloat16, False),   # bf16 b
    (1, 2048, 33, torch.bfloat16, torch.bfloat16, True),  # bf16 a and b
    (2, 31, 2560, torch.float32, torch.float32, False),   # fewer steps than
                                                          # segments
    (1, 5000, 2560, torch.float32, torch.float32, True),  # several spans
    (8, 1000, 2560, torch.float32, torch.bfloat16, True),  # bf16 b, batch 8
    (1, 2048, 2560, torch.float32, torch.float32, False),  # one full span
]


def test_lru_long_sequence_walks_several_spans(cuda):
    p = lru_ops.kernel_plan(5000)
    assert 5000 > p["cluster"] * p["warps"] * p["steps"]
    assert 1 <= lru_ops.kernel_plan(31)["cluster"] <= p["cluster"]


@pytest.mark.parametrize("b,l,w,a_dtype,b_dtype,h0", LRU_CASES)
def test_lru_kernel_matches_plain(cuda, b, l, w, a_dtype, b_dtype, h0):
    gen = torch.Generator(device=cuda).manual_seed(l * 7 + w)
    a = (0.5 + 0.49 * torch.rand((b, l, w), generator=gen,
                                 device=cuda)).to(a_dtype)
    x = torch.randn((b, l, w), generator=gen, device=cuda).to(b_dtype)
    h = torch.randn((b, w), generator=gen, device=cuda) if h0 else None
    before = lru_ops.lru_scan.launches
    gh, gl = lru_ops.lru_scan(a, x, h, "kernel")
    torch.cuda.synchronize()
    assert lru_ops.lru_scan.launches == before + 1
    assert lru_ops.lru_scan.last_plan == lru_ops.kernel_plan(l)
    wh, wl = lru_ops.lru_scan(a, x, h, "plain")
    assert lru_ops.lru_scan.launches == before + 1
    assert gh.dtype == b_dtype and gl.dtype == torch.float32
    slack = 0.0
    if b_dtype == torch.bfloat16:
        _, e = torch.frexp(wh.float().abs())
        slack = torch.ldexp(torch.ones_like(wh, dtype=torch.float32),
                            (e - 8).to(torch.int32))
    d = (gh.float() - wh.float()).abs()
    assert bool((d <= slack + 1e-5 + 1e-5 * wh.float().abs()).all())
    torch.testing.assert_close(gl, wl, rtol=1e-5, atol=1e-5)


def test_lru_kernel_needs_a_cuda_tensor():
    a = torch.ones(1, 4, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        lru_ops.lru_scan(a, a, impl="kernel")


SSD_CASES = [  # (b, l, h, p, n, chunk, dtype, initial state)
    (1, 100, 3, 16, 8, 32, torch.float32, True),     # ragged, carried state
    (2, 64, 5, 8, 4, 16, torch.float32, False),      # a partial head group
    (1, 300, 6, 64, 32, 128, torch.bfloat16, True),  # bf16, ragged
    (1, 64, 2, 128, 16, 32, torch.float32, False),   # head dim 128
    (1, 40, 1, 256, 8, 40, torch.float32, False),    # head dim 256, 1 chunk
    (1, 7, 4, 32, 130, 7, torch.float32, False),     # odd state and chunk
    # the bf16 (tensor-core) kernel's edges
    (1, 120, 4, 64, 32, 40, torch.bfloat16, False),  # chunk 40: not 16k
    (1, 256, 4, 64, 130, 64, torch.bfloat16, False),  # state 130
    (1, 128, 6, 16, 64, 64, torch.bfloat16, False),  # head dim 16
    (1, 128, 3, 128, 64, 64, torch.bfloat16, False),  # head dim 128
    (2, 96, 5, 64, 32, 32, torch.bfloat16, False),   # partial head group
    (1, 1000, 6, 64, 128, 256, torch.bfloat16, True),  # ragged, carried
    (1, 64, 2, 256, 16, 32, torch.bfloat16, False),  # two column slices
    (1, 64, 5, 8, 16, 32, torch.bfloat16, True),     # head dim 8
]


@pytest.mark.parametrize("b,l,h,p,n,chunk,dtype,state", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, b, l, h, p, n, chunk, dtype, state):
    gen = torch.Generator(device=cuda).manual_seed(l * 7 + h)
    x = torch.randn((b, l, h, p), generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=cuda))
    A = -torch.exp(0.2 * torch.randn((h,), generator=gen, device=cuda))
    B, C = (torch.randn((b, l, n), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    s0 = (torch.randn((b, h, p, n), generator=gen, device=cuda) if state
          else None)
    before = ssd_ops.ssd.launches
    gy, gs = ssd_ops.ssd(x, dt, A, B, C, chunk, s0, impl="kernel")
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + 1
    wy, ws = ssd_ops.ssd(x, dt, A, B, C, chunk, s0, impl="plain")
    assert ssd_ops.ssd.launches == before + 1
    assert gy.dtype == dtype and gs.dtype == torch.float32
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(gy.float(), wy.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(gs, ws, rtol=tol, atol=tol)


def test_ssd_kernel_needs_a_cuda_tensor():
    x = torch.zeros(1, 8, 2, 8)
    dt, A, B = torch.zeros(1, 8, 2), -torch.ones(2), torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="needs CUDA"):
        ssd_ops.ssd(x, dt, A, B, B, 8, impl="kernel")


def _rel_err(got, want):
    """max |got - want| over the largest |want|: each gradient's error
    relative to its own scale."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("b,l,w,a_dtype,b_dtype,h0", LRU_CASES)
def test_lru_bwd_kernel_matches_plain(cuda, b, l, w, a_dtype, b_dtype, h0):
    """lru_scan's backward kernel (through autograd of the kernel path)
    against the plain backward (autograd of the plain version): each
    gradient within 1e-5 of its largest magnitude in f32. With a bf16 a or
    b, within 1e-2: the kernel's da_t uses the forward's h_{t-1} as saved,
    rounded to bf16 (relative error up to 2^-8), and bf16 gradients are
    rounded once. Two calls give bit-equal gradients."""
    from repro_torch.kernels.lru_scan import ref as lru_ref

    gen = torch.Generator(device=cuda).manual_seed(l * 5 + w)
    a = (0.5 + 0.49 * torch.rand((b, l, w), generator=gen,
                                 device=cuda)).to(a_dtype)
    x = torch.randn((b, l, w), generator=gen, device=cuda).to(b_dtype)
    h = torch.randn((b, w), generator=gen, device=cuda) if h0 else None
    dh = torch.randn((b, l, w), generator=gen, device=cuda).to(b_dtype)
    dl = torch.randn((b, w), generator=gen, device=cuda) if h0 else None
    leaves = [t.requires_grad_(True) for t in (a, x) + ((h,) if h0 else ())]

    def kernel_grads():
        before = lru_ops.lru_scan.bwd_launches
        gh, gl = lru_ops.lru_scan(leaves[0], leaves[1],
                                  leaves[2] if h0 else None, "kernel")
        if dl is None:     # h_last's cotangent is None: zero
            got = torch.autograd.grad(gh, leaves, dh)
        else:
            got = torch.autograd.grad((gh, gl), leaves, (dh, dl))
        torch.cuda.synchronize()
        assert lru_ops.lru_scan.bwd_launches == before + 1
        return got

    got, again = kernel_grads(), kernel_grads()
    want = lru_ref.lru_scan_vjp_ref(a, x, h, dh, dl)
    tol = 1e-5 if a_dtype == b_dtype == torch.float32 else 1e-2
    for g, g2, w_ in zip(got, again, want):
        assert g.dtype == w_.dtype and torch.equal(g, g2)
        assert _rel_err(g, w_) <= tol


def test_lru_bwd_takes_a_strided_cotangent(cuda):
    """A non-contiguous cotangent of h is made contiguous."""
    from repro_torch.kernels.lru_scan import ref as lru_ref

    a = (0.5 + 0.4 * torch.rand((2, 300, 70), device=cuda)).requires_grad_()
    x = torch.randn((2, 300, 70), device=cuda).requires_grad_()
    dh = torch.randn((2, 70, 300), device=cuda).transpose(1, 2)
    gh, _ = lru_ops.lru_scan(a, x, impl="kernel")
    got = torch.autograd.grad(gh, (a, x), dh)
    want = lru_ref.lru_scan_vjp_ref(a, x, None, dh)
    for g, w_ in zip(got, want):
        assert _rel_err(g, w_) <= 1e-5


SSD_BWD_CASES = [  # (b, l, h, p, n, chunk, dtype)
    (1, 100, 3, 16, 8, 32, torch.float32),      # ragged: padded with dt = 0
    (2, 64, 5, 8, 4, 16, torch.float32),        # head dim 8
    (1, 7, 4, 32, 130, 7, torch.float32),       # odd state and chunk
    (1, 40, 1, 256, 8, 40, torch.float32),      # head dim 256, one chunk
    (1, 300, 6, 64, 32, 128, torch.bfloat16),   # bf16, ragged
    (2, 512, 48, 64, 128, 256, torch.float32),  # Mamba-2's widths, f32
    (2, 512, 48, 64, 128, 256, torch.bfloat16),  # and bf16
    # the bf16 tensor-core path's edges
    (1, 512, 13, 64, 128, 256, torch.bfloat16),  # 13 heads, odd
    (1, 256, 4, 32, 130, 128, torch.bfloat16),   # state 130: padded to 160
    (2, 128, 5, 8, 16, 64, torch.bfloat16),      # head dim 8
    (1, 128, 2, 256, 32, 64, torch.bfloat16),    # head dim 256: SIMT kernels
    (1, 200, 2, 128, 64, 100, torch.bfloat16),   # head dim 128: SIMT kernels
    (1, 300, 3, 64, 64, 100, torch.bfloat16),    # chunk 100: ragged tiles
    (1, 40, 3, 16, 32, 64, torch.bfloat16),      # one ragged chunk
]


def _ssd_inputs(cuda, b, l, h, p, n, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, l, h, p), generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=cuda))
    A = -torch.exp(0.2 * torch.randn((h,), generator=gen, device=cuda))
    B, C = (torch.randn((b, l, n), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    return x, dt, A, B, C, gen


@pytest.mark.parametrize("b,l,h,p,n,chunk,dtype", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain(cuda, b, l, h, p, n, chunk, dtype):
    """The gradients of ops.ssd (y and the final state, random
    cotangents) through the kernel path (ssd_chunk_bwd for the
    within-chunk terms, autograd for the rest) against autograd of the
    plain path: each within 1e-4 (f32) or 5e-2 (bf16) of its largest
    magnitude, the forward's SSD tolerances; then the chunk terms'
    backward alone against ssd_chunk_terms_vjp_ref, and two calls
    bit-equal."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    x, dt, A, B, C, gen = _ssd_inputs(cuda, b, l, h, p, n, dtype, l + h)
    dy = torch.randn((b, l, h, p), generator=gen, device=cuda).to(dtype)
    ds = torch.randn((b, h, p, n), generator=gen, device=cuda)
    leaves = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    grads = {}
    for impl in ("kernel", "plain"):
        before = ssd_ops.ssd.bwd_launches
        y, st = ssd_ops.ssd(*leaves, chunk, impl=impl)
        grads[impl] = torch.autograd.grad((y, st), leaves, (dy, ds))
        torch.cuda.synchronize()
        assert ssd_ops.ssd.bwd_launches == before + (impl == "kernel")
    for g, w_ in zip(grads["kernel"], grads["plain"]):
        assert g.dtype == w_.dtype and bool(torch.isfinite(g).all())
        assert _rel_err(g, w_) <= tol
    # the within-chunk terms' backward alone, on a chunk multiple
    lc = l // chunk * chunk
    if lc == 0:
        return
    xs, dts, Bs, Cs = (t.detach()[:, :lc] for t in (x, dt, B, C))
    c = lc // chunk
    cots = (torch.randn((b, c, chunk, h, p), generator=gen, device=cuda),
            torch.randn((b, c, h, n, p), generator=gen, device=cuda),
            torch.randn((b, c, chunk, h), generator=gen, device=cuda))
    runs = [ssd_ops._launch_bwd(xs.contiguous(), dts.contiguous(),
                                A.detach(), Bs.contiguous(), Cs.contiguous(),
                                chunk, *cots) for _ in range(2)]
    parts = (xs.reshape(b, c, chunk, h, p), dts.reshape(b, c, chunk, h),
             A.detach(), Bs.reshape(b, c, chunk, n),
             Cs.reshape(b, c, chunk, n))
    want = ssd_ref.ssd_chunk_terms_vjp_ref(
        *parts, cots[0], cots[1].transpose(-1, -2), cots[2])
    for g, g2, w_ in zip(*runs, want):
        assert torch.equal(g, g2)
        assert _rel_err(g.reshape(w_.shape), w_) <= tol


@pytest.mark.parametrize("arch,kernel,layers", [
    ("mamba2-780m", "ssd", 4), ("recurrentgemma-2b", "lru", 3)])
def test_recurrent_trained_on_card_equals_cpu(cuda, arch, kernel, layers):
    """The reduced Mamba-2 (scanned) and RecurrentGemma in float32, remat
    "full", 2 steps from the same parameters on the card (the scans'
    forward and backward kernels) and on the CPU (autograd of the plain
    versions): losses and grad norms within rtol 1e-4 (the trainer
    tolerance of the CPU tests), parameters within 1e-4 of each leaf's
    largest entry except where AdamW's second moment is below (1e3 *
    eps)^2: there it divides a gradient of about eps by one of about eps,
    so last-bit differences of the gradient become O(1) differences of the
    step, and an entry may differ by up to the summed learning rates
    (tests/test_torch_trainer.py::test_moe_trainer_matches_jax's rule; on
    the card one embedding entry of reduced Mamba-2, whose v is 1.3e-16,
    moved 1.6e-4). 2 forward launches (the remat recompute) and 1 backward
    launch a recurrent layer a step."""
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions
    from repro_torch.runtime.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    wrapper = ssd_ops.ssd if kernel == "ssd" else lru_ops.lru_scan
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        run = RunConfig(
            model=get_arch(arch).reduced(),
            parallel=ParallelConfig(remat="full", scan_layers=True),
            train=TrainConfig(global_batch=4, seq_len=64, total_steps=2,
                              warmup_steps=1, lr=5e-3, seed=3,
                              checkpoint_every=10 ** 9))
        t = Trainer(run, device=dev, options=ModelOptions(
            dtype=torch.float32, scan_layers=True, remat="full"))
        t.init_state(params=t.model.init(0, "cpu").to(dev))
        before = (wrapper.launches, wrapper.bwd_launches)
        t.train(2)
        torch.cuda.synchronize()
        launched = (wrapper.launches - before[0],
                    wrapper.bwd_launches - before[1])
        assert launched == ((4 * layers, 2 * layers) if dev.type == "cuda"
                            else (0, 0))
        runs[dev.type] = t
    a, b = runs["cuda"], runs["cpu"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in a.metrics_log],
                                   [m[key] for m in b.metrics_log],
                                   rtol=1e-4)
    eps, lr_sum = b.opt_cfg.eps, sum(m["lr"] for m in b.metrics_log)
    for p, q, v in zip(tree_leaves(a.params), tree_leaves(b.params),
                       tree_leaves(b.opt_state["v"])):
        p, q, v = p.detach().cpu(), q.detach(), v.detach()
        diff = (p - q).abs()
        tiny = (v > 0) & (v < (1e3 * eps) ** 2)
        assert bool((diff[~tiny] <= 1e-4 * q[~tiny].abs()
                     + 1e-4 * q.abs().max()).all())
        assert bool((diff[tiny] <= lr_sum).all())


@pytest.mark.parametrize("arch,kernel,per_prefill", [
    ("mamba2-780m", "ssd", 4), ("recurrentgemma-2b", "lru", 3)])
def test_recurrent_served_on_card_equals_cpu(cuda, arch, kernel,
                                             per_prefill):
    """The reduced Mamba-2 and RecurrentGemma (float32) served continuously
    on the card give the CPU's greedy tokens and prefill logits within
    1e-4, with one recurrent-kernel launch per recurrent layer per
    prefill."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import BatchServer, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    wrapper = ssd_ops.ssd if kernel == "ssd" else lru_ops.lru_scan
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.float32))
    params = model.init(0, "cpu")
    prompts = [[5, 9, 3, 200, 17], [7], list(range(1, 70)), [11] * 33]
    outs, logits = {}, {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        logits[str(dev)] = model.prefill(
            p, {"tokens": torch.tensor([prompts[2]], device=dev)})[0].cpu()
        srv = BatchServer(model, p, slots=3, max_len=96)
        for pr in prompts:
            srv.submit(Request(prompt=list(pr), max_new_tokens=8))
        before = wrapper.launches
        served = srv.run_continuous()
        launched = wrapper.launches - before
        assert launched == (per_prefill * srv.stats["prefills"]
                            if dev != "cpu" else 0)
        outs[str(dev)] = {r.rid: r.output for r in served}
    assert outs["cpu"] == outs[str(cuda)]
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-4,
                               atol=1e-4)

"""The readers of the program's spans on a small canned Chrome trace, and
on the card at the cell's size (marked ``gpu``)."""
import time

import pytest
import torch

from gpubench import bench, trace
from gpubench.tests.test_gb_metrics import _events as _no_spans

SPAN_METRICS = ("host_gap_ms", "fwd_ms", "recompute_ms", "bwd_ms",
                "ssm_proj_ms", "ssm_conv_ms", "ssm_scan_ms",
                "ssm_gate_norm_ms")
PHASES = ("fwd_ms", "recompute_ms", "bwd_ms", "adamw_ms")
PARTS = ("ssm_proj_ms", "ssm_conv_ms", "ssm_scan_ms", "ssm_gate_norm_ms")


def _events():
    """Two steps 10 ms apart. The host thread (tid 1) runs the trainer's
    spans, the forward and AdamW; autograd's device thread (tid 2) the
    backward, with a layer's recompute inside ``ssm.proj.bwd``. Times in
    microseconds, device ops on stream 7."""
    ev = []

    def host(name, ts, end, tid=1):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": ts, "dur": end - ts, "tid": tid})

    def op(name, ts, end, corr, launch, tid=1, cat="kernel"):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "ts": launch, "dur": 1, "tid": tid,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": end - ts, "tid": 7, "args": {"correlation": corr}})

    for s in range(2):
        b, c = s * 10_000, s * 100
        host("gpubench_step", b, b + 10_000)
        host("trainer.place_batch", b, b + 100)
        host("trainer.step", b + 100, b + 6100)
        host("step.fwd", b + 150, b + 2000)
        host("layer.fwd", b + 200, b + 1900)
        host("ssm.proj", b + 210, b + 300)
        host("ssm.conv", b + 310, b + 400)
        host("ssm.scan", b + 460, b + 480)
        host("step.bwd", b + 2100, b + 4900, tid=2)
        host("ssm.proj.bwd", b + 2150, b + 3000, tid=2)
        host("layer.recompute", b + 2300, b + 2900, tid=2)
        host("ssm.conv", b + 2400, b + 2500, tid=2)
        host("ssm.conv.bwd", b + 3100, b + 3500, tid=2)
        host("ssm.gate_norm.bwd", b + 3550, b + 3590, tid=2)
        host("adamw_update", b + 5000, b + 6000)
        host("trainer.readback", b + 6100, b + 7100)
        host("trainer.log", b + 7100, b + 7500)
        op("h2d", b + 200, b + 210, c + 1, b + 50, cat="gpu_memcpy")
        op("gemm", b + 300, b + 500, c + 2, b + 220)
        op("conv", b + 500, b + 800, c + 3, b + 320)
        op("norm", b + 800, b + 900, c + 4, b + 450)
        op("ssd_chunk_tc", b + 900, b + 1000, c + 5, b + 470)
        op("gemm_bwd", b + 2200, b + 2600, c + 6, b + 2200, tid=2)
        op("conv", b + 2600, b + 2900, c + 7, b + 2410, tid=2)
        op("norm", b + 2900, b + 3000, c + 8, b + 2600, tid=2)
        op("conv_bwd", b + 3000, b + 3600, c + 9, b + 3200, tid=2)
        op("gate_bwd", b + 3600, b + 3700, c + 10, b + 3560, tid=2)
        op("residual_bwd", b + 3700, b + 3900, c + 11, b + 3700, tid=2)
        op("adam", b + 6500, b + 7000, c + 12, b + 5100)
        op("d2h", b + 7000, b + 7010, c + 13, b + 6110, cat="gpu_memcpy")
    return ev


def _ctx(events, steps=2):
    t = trace.parse(events, wall_s=0.020, steps=steps)
    return {"trace": t, "counters": {}}


def read(name, ctx):
    return bench.metric_reader(name).read(ctx)


def test_phases():
    ctx = _ctx(_events())
    assert read("fwd_ms", ctx) == pytest.approx(0.7)
    assert read("recompute_ms", ctx) == pytest.approx(0.4)
    assert read("bwd_ms", ctx) == pytest.approx(1.3)
    assert read("adamw_ms", ctx) == pytest.approx(0.5)
    t = ctx["trace"]
    covered = sum(read(m, ctx) for m in PHASES)
    assert covered == pytest.approx(2.9)
    assert covered >= 0.99 * 1e3 * t.busy_s() / t.steps


def test_mixer_parts_take_the_innermost_span():
    """The recompute's conv counts under ``ssm.conv``, not under the
    ``ssm.proj.bwd`` it runs in; its norm under neither."""
    ctx = _ctx(_events())
    assert read("ssm_proj_ms", ctx) == pytest.approx(0.6)
    assert read("ssm_conv_ms", ctx) == pytest.approx(1.2)
    assert read("ssm_scan_ms", ctx) == pytest.approx(0.1)
    assert read("ssm_gate_norm_ms", ctx) == pytest.approx(0.1)
    parts = sum(read(m, ctx) for m in PARTS)
    assert parts <= sum(read(m, ctx) for m in PHASES[:3])


def test_host_gap_counts_idle_time_outside_the_step():
    """Each step leaves its step span with the card busy until 6500
    (400 us idle outside the span); the hole from 7010 to the next
    step's first copy at 10200 straddles that step's start at 10100."""
    ctx = _ctx(_events())
    assert read("host_gap_ms", ctx) == pytest.approx(
        (400 + 3090 + 400) / 2 / 1e3)
    t = ctx["trace"]
    assert read("host_gap_ms", ctx) * t.steps / 1e3 <= t.wall_s - t.busy_s()


def test_backward_ops_carry_the_device_threads_spans():
    t = _ctx(_events())["trace"]
    conv_bwd = [o for o in t.ops if o.name == "conv_bwd"]
    assert len(conv_bwd) == 2
    for o in conv_bwd:
        assert o.ranges == ("step.bwd", "ssm.conv.bwd")


def test_span_readers_find_nothing_without_the_programs_spans():
    ctx = _ctx(_no_spans())
    for name in SPAN_METRICS:
        assert read(name, ctx) is None, name


@pytest.mark.gpu
def test_two_traced_steps_at_the_cells_size_are_covered():
    """The cell's configuration, two traced steps on the card: every span
    metric reads, the four phases hold every device op once and cover
    99% of the busy time, the mixer's parts fit inside the phases, the
    host gaps inside the idle time, and no idle gap over 1 ms is left to
    the harness's own range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    from gpubench.workloads import train

    cell = bench.cell("mamba2-780m.train_16x2k")
    trainer, _ = train.start(cell, 2**31 + 11, "cuda")
    res = train._traced(trainer, 2, "cuda", time.perf_counter(), ())
    del trainer
    train.free("cuda")
    t = res["trace"]
    ctx = {"trace": t, "counters": {}}
    values = {m: read(m, ctx) for m in SPAN_METRICS + PHASES}
    assert all(v is not None for v in values.values()), values
    busy_ms = 1e3 * t.busy_s() / t.steps
    assert sum(values[m] for m in PHASES) >= 0.99 * busy_ms, values
    for o in t.ops:
        under = ["step.fwd" in o.ranges, "layer.recompute" in o.ranges,
                 "step.bwd" in o.ranges and "layer.recompute" not in o.ranges,
                 "adamw_update" in o.ranges]
        assert sum(under) <= 1, o
    assert sum(values[m] for m in PARTS) <= sum(
        values[m] for m in PHASES[:3])
    assert values["host_gap_ms"] * t.steps <= 1e3 * (t.wall_s - t.busy_s())
    long_gaps = [g for g in t.idle_gaps(50) if g[1] > 1e-3]
    assert all(name != "gpubench_step" for name, _ in long_gaps), long_gaps

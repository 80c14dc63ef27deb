"""Each per-layer reader on a small canned Chrome trace."""
import pytest

from gpubench import bench, trace
from gpubench.flops import ssm as flops_ssm

CFG = bench.load_json(bench.ROOT / "gpubench/configs/mamba2-780m.json")
TRAFFIC = {"batch": 16, "seq_len": 2048}
PEAKS = {"bf16_flops_per_s": 1e15, "hbm_bytes_per_s": 1e12}


def _events():
    """Two steps on one host thread (tid 1) and one autograd thread
    (tid 2); device ops on stream 7. Times in microseconds."""
    ev = []

    def host(name, ts, dur, tid=1, cat="user_annotation"):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "tid": tid})

    def kernel(name, ts, dur, corr, launch_ts, tid=1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "ts": launch_ts, "dur": 1, "tid": tid,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": 7, "args": {"correlation": corr}})

    for s in range(2):
        base = s * 10_000
        host("gpubench_step", base, 10_000)
        host("aten::mm", base + 10, 100, cat="cpu_op")
        kernel("void (anonymous namespace)::ssd_chunk_tc<64>(...)",
               base + 100, 1000, 10 * s + 1, base + 20)
        host("linear_xent_backward", base + 200, 300, tid=2)
        kernel("gemm", base + 1100, 500, 10 * s + 2, base + 250, tid=2)
        kernel("void (anonymous namespace)::ssd_bwd::bwd_tc<64>(...)",
               base + 1600, 2000, 10 * s + 3, base + 600)
        kernel("void (anonymous namespace)::ssd_bwd::bwd_dA(...)",
               base + 3600, 400, 10 * s + 4, base + 610)
        host("adamw_update", base + 5000, 1000)
        kernel("add", base + 5000, 3000, 10 * s + 5, base + 5100)
    return ev


@pytest.fixture
def ctx():
    t = trace.parse(_events(), wall_s=0.020, steps=2)
    t.counters = {"repro_torch.kernels.ssd_scan.ops:ssd.bwd_launches": 2}
    return {"trace": t, "config": CFG, "traffic": TRAFFIC, "peaks": PEAKS,
            "counters": t.counters, "flops": flops_ssm}


def read(name, ctx):
    return bench.metric_reader(name).read(ctx)


def test_trace_parse(ctx):
    t = ctx["trace"]
    assert len(t.ops) == 10
    assert t.busy_s() == pytest.approx(2 * 6900e-6)
    assert t.device_span_s() == pytest.approx(0.0179)
    xent = [o for o in t.ops if o.name == "gemm"]
    assert all("linear_xent_backward" in o.ranges for o in xent)
    gaps = t.idle_gaps(3)
    assert gaps[0][1] == pytest.approx(0.0021)      # 8000 -> 10100
    assert gaps[0][0] == "gpubench_step"


def test_idle_share(ctx):
    assert read("device_idle_share", ctx) == pytest.approx(
        100 * (1 - 2 * 6900e-6 / 0.020))


def test_ms_readers(ctx):
    assert read("adamw_ms", ctx) == pytest.approx(3.0)
    assert read("xent_ms", ctx) == pytest.approx(0.5)


def test_rooflines(ctx):
    flops, nbytes = flops_ssm.ssd_fwd_cost(CFG, 16, 2048)
    bound = max(flops / 1e15, nbytes / 1e12)
    assert read("ssd_fwd_roofline", ctx) == pytest.approx(
        100 * bound / 1e-3)
    flops, nbytes = flops_ssm.ssd_bwd_cost(CFG, 16, 2048)
    bound = max(flops / 1e15, nbytes / 1e12)
    assert read("ssd_bwd_roofline", ctx) == pytest.approx(
        100 * bound / 2.4e-3)


def test_mfu(ctx):
    flops = flops_ssm.step_flops(CFG, 16, 2048)
    assert read("train_mfu", ctx) == pytest.approx(
        100 * 2 * flops / 0.0179 / 1e15)


def test_readers_find_nothing_in_an_empty_trace(ctx):
    ctx["trace"] = trace.parse([], wall_s=0.01, steps=2)
    ctx["counters"] = {}
    for m in bench.benchmark()["per_layer"]:
        assert read(m["name"], ctx) is None

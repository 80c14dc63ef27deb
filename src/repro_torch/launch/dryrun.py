"""Multi-pod dry run: the port of ``repro/launch/dryrun.py``. Every (arch x
shape x mesh) cell on the production meshes (16x16 single-pod, 2x16x16
multi-pod) is lowered for rank 0 of a fake process group of 256 or 512
ranks and run once under fake tensors (``Cell.lower(mesh).compile()``,
``analysis/fake_run.py``), and the roofline terms are read from that
pass. No card is needed, nor any data: every tensor is a fake one.

Per cell:
  runnable pass  — the scanned-layer layout (the production step). Proves
                   that the rank's step runs on its blocks with its
                   collectives; ``memory_analysis()`` (live storages) is
                   the HBM-fit check.
  analysis pass  — the unrolled layout at k0 and k1 = k0 + period layers;
                   FLOPs / bytes / collective wire bytes extrapolate
                   linearly to the full depth, as the reference's (the fake
                   pass counts every layer of a scanned stack too, so the
                   runnable pass's figures are whole as well).

Fake CPU tensors take the scans' plain versions (``ref.py``) and dense or
blockwise attention, as the reference's dry run on XLA-CPU takes
``impl="auto"``'s reference; every record says so (``"impl"``).

Usage (no card, no jax):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --report         # aggregate
"""
import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# Per-arch overrides applied to BOTH passes (recorded in the JSON), the
# reference's: llama3-405b keeps bf16 AdamW moments (f32 ones alone are 12.7
# GB a rank of 256) and 8 microbatches (one microbatch's remat saves and
# logits at a time).
ARCH_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "llama3-405b": {"moment_dtype": "bfloat16", "accum_steps": 8},
}


def _build(arch: str, shape_name: str, analysis: bool,
           num_layers: Optional[int]):
    import torch

    from repro_torch.config.base import ParallelConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.config.shapes import shape_by_name
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.model import ModelOptions

    cfg = get_arch(arch)
    shape = shape_by_name(shape_name)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    over = ARCH_OVERRIDES.get(arch, {})
    moment_dtype = getattr(torch, over.get("moment_dtype", "float32"))

    # Blockwise attention wherever the sequence is long enough to matter:
    # the dense path holds (b, h, s, s) f32 scores. Decode always uses the
    # ring-cache dense path (one query token).
    if analysis:
        # accum kept at 1: FLOPs/collectives per token are accum-invariant
        options = ModelOptions(
            attn_impl="blockwise_unrolled" if shape.kind != "decode"
            else "dense",
            scan_layers=False,
            remat="full" if shape.kind == "train" else "none")
        parallel = ParallelConfig(scan_layers=False, remat=options.remat)
    else:
        options = ModelOptions(
            attn_impl="blockwise" if shape.kind != "decode" else "dense",
            scan_layers=True,
            remat="full" if shape.kind == "train" else "none")
        parallel = ParallelConfig(scan_layers=True, remat=options.remat,
                                  accum_steps=int(over.get("accum_steps", 1)))
    return build_cell(cfg, shape, options, parallel, moment_dtype)


def _layer_period(arch: str) -> int:
    from repro_torch.config.registry import get_arch

    cfg = get_arch(arch)
    if cfg.family == "hybrid":
        return len(cfg.hybrid.pattern)
    return 1


def _extract(compiled) -> Dict[str, Any]:
    cost = compiled.cost_analysis()
    mem = compiled.memory_analysis()
    coll = compiled.collectives()
    return {
        "flops": float(cost.get("flops", 0.0)),
        "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
        "coll_wire_bytes": coll.total_wire_bytes,
        "coll_wire_bytes_bf16eq": coll.total_wire_bytes_bf16eq,
        "coll_operand_bytes": coll.total_operand_bytes,
        "coll_by_kind": {k: [n, b] for k, (n, b) in coll.by_kind().items()},
        "coll_by_axes": {k: [n, b] for k, (n, b) in coll.by_axes().items()},
        "mem": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes,
        },
        "op_counts": compiled.op_counts(),
        "impl": compiled.notes,
    }


def _analytic_traffic(cell, cfg, shape, mesh) -> Dict[str, float]:
    """Analytic per-rank HBM traffic (``analysis/memtraffic.py``)."""
    from repro_torch.analysis.memtraffic import hbm_traffic, sharded_bytes

    ctx = cell.context(mesh)
    chips = mesh.size
    pb = sharded_bytes(cell.arg_specs[0], cell.arg_axes[0], ctx)
    mb = cb = 0.0
    if cell.kind == "train":
        mb = sharded_bytes(cell.arg_specs[1]["m"], cell.arg_axes[1]["m"],
                           ctx) * 2
    elif cell.kind == "decode":
        cb = sharded_bytes(cell.arg_specs[1], cell.arg_axes[1], ctx)
    traffic = hbm_traffic(cfg, shape, chips, pb, mb, cb,
                          remat=(cell.kind == "train"))
    return {"param_bytes_chip": pb, "moment_bytes_chip": mb,
            "cache_bytes_chip": cb, "hbm_traffic_chip": traffic}


def fake_group(world: int) -> None:
    """A fake default process group of `world` ranks, this process rank 0
    (``torch.testing._internal.distributed.fake_pg``: groups are made,
    nothing is sent); one of another size is destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool, analysis: bool,
             out_dir: Path) -> Dict[str, Any]:
    """Lower and run one cell on one mesh; write JSON; return the record."""
    import torch.distributed as dist

    from repro_torch.config.registry import get_arch
    from repro_torch.config.shapes import cell_is_runnable, shape_by_name
    from repro_torch.launch.mesh import (make_production_mesh,
                                         validate_production_mesh)

    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}" + (
        "__analysis" if analysis else "")
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "analysis": analysis, "tag": tag,
    }
    out_dir.mkdir(parents=True, exist_ok=True)

    cfg = get_arch(arch)
    shape = shape_by_name(shape_name)
    if not cell_is_runnable(cfg.subquadratic, shape):
        rec.update(skipped=True,
                   reason="long_500k requires sub-quadratic attention; "
                          f"{arch} is pure full-attention (DESIGN.md §5)")
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] SKIP {tag}: {rec['reason']}")
        return rec

    fake_group(512 if multi_pod else 256)
    rec["world_size"] = dist.get_world_size()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    validate_production_mesh(mesh, multi_pod=multi_pod)
    try:
        if analysis:
            period = _layer_period(arch)
            k0, k1 = period, 2 * period
            metrics = {}
            for k in (k0, k1):
                cell = _build(arch, shape_name, analysis=True, num_layers=k)
                t0 = time.time()
                lowered = cell.lower(mesh)
                compiled = lowered.compile()
                m = _extract(compiled)
                m["lower_compile_s"] = time.time() - t0
                metrics[k] = m
            L = cfg.num_layers
            extrap: Dict[str, Any] = {}
            for key in ("flops", "bytes_accessed", "coll_wire_bytes",
                        "coll_wire_bytes_bf16eq", "coll_operand_bytes"):
                per = (metrics[k1][key] - metrics[k0][key]) / (k1 - k0)
                extrap[key] = metrics[k1][key] + per * (L - k1)
                extrap[f"{key}_per_layer"] = per
            # collective wire bytes by the mesh axes of their groups
            by0, by1 = (metrics[k]["coll_by_axes"] for k in (k0, k1))
            extrap["coll_wire_bytes_by_axes"] = {
                a: by1.get(a, [0, 0.0])[1] + (
                    by1.get(a, [0, 0.0])[1] - by0.get(a, [0, 0.0])[1])
                / (k1 - k0) * (L - k1) for a in sorted({*by0, *by1})}
            rec.update(ok=True, k0=k0, k1=k1, layers=L,
                       raw={str(k): metrics[k] for k in metrics},
                       extrapolated=extrap)
        else:
            cell = _build(arch, shape_name, analysis=False, num_layers=None)
            t0 = time.time()
            lowered = cell.lower(mesh)
            t_lower = time.time() - t0
            compiled = lowered.compile()
            t_compile = time.time() - t0 - t_lower
            rec.update(ok=True, lower_s=t_lower, compile_s=t_compile,
                       **_extract(compiled))
            rec["analytic"] = _analytic_traffic(cell, cfg, shape, mesh)
            print(compiled.memory_analysis())
    except Exception as e:  # recorded, not raised: the report shows red cells
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    status = "OK" if rec.get("ok") else "FAIL"
    print(f"[dryrun] {status} {tag}", flush=True)
    return rec


# --------------------------------------------------------------------- report
def load_records(out_dir: Path) -> List[Dict[str, Any]]:
    return [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]


def report(out_dir: Path) -> str:
    from repro_torch.analysis.roofline import (H100, RooflineReport,
                                               model_flops_for)
    from repro_torch.config.registry import get_arch
    from repro_torch.config.shapes import shape_by_name

    recs = load_records(out_dir)
    runnable = [r for r in recs if not r.get("analysis")]
    analysis = {(r["arch"], r["shape"]): r for r in recs
                if r.get("analysis") and r.get("ok")}

    lines = ["## Dry-run results (fake process groups, one pass under fake "
             "tensors for rank 0; bytes from live storages)", "",
             "| arch | shape | mesh | status | run s | args GB/rank | "
             "temp GB/rank |",
             "|---|---|---|---|---|---|---|"]
    for r in sorted(runnable, key=lambda r: (r["arch"], r["shape"],
                                             r["mesh"])):
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"SKIP ({r['reason'][:40]}...) | – | – | – |")
            continue
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"**FAIL** {r.get('error', '')[:60]} | – | – | – |")
            continue
        mem = r["mem"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r.get('compile_s', 0):.1f} | {mem['argument_bytes']/1e9:.2f} | "
            f"{mem['temp_bytes']/1e9:.2f} |")

    runnable_by_key = {(r["arch"], r["shape"]): r for r in runnable
                       if r.get("ok") and r["mesh"] == "16x16"}
    baseline_dir = out_dir.parent / "dryrun_torch_baseline"
    baselines = {}
    if baseline_dir.exists():
        for rec in (json.loads(p.read_text())
                    for p in baseline_dir.glob("*__analysis.json")):
            if rec.get("ok"):
                baselines[(rec["arch"], rec["shape"])] = rec

    lines += ["", "## Roofline (single-pod 16x16; computed from NVIDIA H100 "
              f"SXM data-sheet constants ({H100.peak_flops:.4g} FLOP/s bf16, "
              f"{H100.hbm_bw:.4g} B/s HBM, {H100.link_bw:.4g} B/s a link), "
              "not measured; FLOPs/collectives from the unrolled analysis "
              "pass, t_mem from the analytic HBM model)",
              "",
              "| arch | shape | t_comp ms | t_mem ms | t_coll ms | dominant | "
              "useful ratio | roofline frac | coll GB vs baseline |",
              "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape_name), r in sorted(analysis.items()):
        if r["mesh"] != "16x16":
            continue
        cfg = get_arch(arch)
        shape = shape_by_name(shape_name)
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        mf = model_flops_for(cfg.active_params(), tokens, shape.kind)
        e = r["extrapolated"]
        coll = e.get("coll_wire_bytes_bf16eq", e["coll_wire_bytes"])
        run = runnable_by_key.get((arch, shape_name), {})
        hbm = run.get("analytic", {}).get("hbm_traffic_chip",
                                          e["bytes_accessed"])
        rep = RooflineReport(
            arch=arch, shape=shape_name, mesh=r["mesh"], chips=256,
            hlo_flops=e["flops"], hlo_bytes=hbm,
            coll_bytes=coll, model_flops=mf)
        base = baselines.get((arch, shape_name))
        if base:
            b_coll = base["extrapolated"]["coll_wire_bytes"]
            delta = (f"{b_coll/1e9:.1f} → {e['coll_wire_bytes']/1e9:.1f} "
                     f"({b_coll/max(e['coll_wire_bytes'], 1e-9):.1f}x)")
        else:
            delta = "–"
        lines.append(
            f"| {arch} | {shape_name} | {rep.t_comp*1e3:.2f} | "
            f"{rep.t_mem*1e3:.2f} | {rep.t_coll*1e3:.2f} | {rep.dominant} | "
            f"{rep.useful_flops_ratio:.3f} | {rep.roofline_fraction:.3f} | "
            f"{delta} |")
    return "\n".join(lines)


# ----------------------------------------------------------------------- main
def all_cells() -> List[Dict[str, Any]]:
    from repro_torch.config.registry import list_archs
    from repro_torch.config.shapes import SHAPES

    cells = []
    for arch in list_archs():
        for shape in SHAPES:
            cells.append({"arch": arch, "shape": shape})
    return cells


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--analysis", action="store_true",
                    help="unrolled analysis pass (single-pod roofline terms)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    if args.report:
        print(report(args.out))
        return 0

    todo = (all_cells() if args.all
            else [{"arch": args.arch, "shape": args.shape}])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    rc = 0
    # every cell of one mesh before the next: the fake group is started
    # once for each
    for multi in meshes:
        if args.analysis and multi:
            continue  # roofline table is single-pod only (brief)
        for cell in todo:
            r = run_cell(cell["arch"], cell["shape"], multi_pod=multi,
                         analysis=args.analysis, out_dir=args.out)
            if not (r.get("ok") or r.get("skipped")):
                rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

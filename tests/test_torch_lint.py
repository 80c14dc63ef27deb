"""The port's schedule linter (``analysis/comm_log.py``, ``analysis/rules``,
``analysis/lint_targets.py``, ``analysis/schedule_lint.py``) against the
JAX package's HLO linter.

(a) Each of the eight rules on hand-written logs, as
``tests/test_hlo_lint.py`` does on hand-written HLO: it fires on the
broken shape and not on the right one.
(b) Every canonical target lints clean, and every broken target trips
exactly its own rules (``lint_targets.TRIPS``).
(c) The invariants of the eight JAX HLO tests that fail on jax 0.9.0
(``ROADMAP.md``, "Caution for choosing oracles"), held on the port's logs:
the two-phase mutations (WIRE-WIDEN, NO-OVERLAP-WINDOW), the peeled halo
scans' send counts at 4 and 8 ranks and the unpeeled drain, the ZeRO-3
step's one reduce-scatter and one all-gather per buffer in schedule order
(and a doubled gather caught), streaming's gather adjacency, the grad
sync's reverse-topological issue, the TP decode step and its two-phase
fixture, and the CLI's JSON and exit codes.
(d) The lint contexts' expectations (send totals, bucket element lists,
parameter budgets, all-to-all and decode counts) against those the JAX
package's targets derive, from its own schedule code, without lowering
anything.
(e) The TP train step's gathers: per layer, at most two layers' blocks
live at once, and the gather-all schedule it replaced holds every
layer's at once.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import lint_targets as lt
from repro_torch.analysis.comm_log import (CommLog, collective_bytes,
                                           collective_summary, count_ops,
                                           record)
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID, LintContext
from repro_torch.analysis.rules.buckets import ag_live_spans
from repro_torch.analysis.schedule_lint import lint_log, main

REPO = Path(__file__).resolve().parents[1]


def _rules(report):
    return sorted({f.rule for f in report.errors})


@functools.lru_cache(maxsize=None)
def _target(name):
    return lt.build(name)


@functools.lru_cache(maxsize=None)
def _report(name):
    tgt = _target(name)
    return lint_log(tgt.log, tgt.ctx, target=name)


def _coll(log, kind, n, dtype="f32", axes=("data",), async_op=False,
          reads=(), writes=(), peer=None):
    return log.add(kind, dtype=dtype, elements=n, axes=axes,
                   group_size=4, async_op=async_op, peer=peer,
                   reads=frozenset(reads), writes=frozenset(writes))


def _op(log, reads=(), writes=(), n=64, compute=True, name="mul"):
    return log.add("op", name=name, elements=n, compute=compute,
                   reads=frozenset(reads), writes=frozenset(writes))


# ------------------------------------------------------------------- rules
def test_registry_is_complete():
    ids = [r.id for r in ALL_RULES]
    assert len(ids) == len(set(ids)) == 8
    assert set(RULES_BY_ID) == set(ids)
    for r in ALL_RULES:
        assert r.fix_hint and (r.__doc__ or "").strip()
    from repro.analysis.rules import RULES_BY_ID as JAX_RULES

    assert set(RULES_BY_ID) == set(JAX_RULES)


def test_dead_drain_fires_on_an_unread_receive():
    log = CommLog()
    _coll(log, "recv", 16, async_op=True, writes=(1,), peer=1)
    _op(log, reads=(2,), writes=(3,))
    rep = lint_log(log, LintContext())
    assert _rules(rep) == ["DEAD-DRAIN"]
    log = CommLog()
    _coll(log, "recv", 16, async_op=True, writes=(1,), peer=1)
    _op(log, reads=(1,), writes=(3,), compute=False, name="cat")
    assert lint_log(log, LintContext()).ok
    # a receive the step returns is not dead
    log = CommLog()
    _coll(log, "recv", 16, async_op=True, writes=(1,), peer=1)
    log.outputs = frozenset({1})
    assert lint_log(log, LintContext()).ok


def test_pair_count_total_per_axis_and_balance():
    def sends(peers, axes=("data",)):
        log = CommLog()
        for p in peers:
            _coll(log, "send", 16, async_op=True, reads=(0,), peer=p,
                  axes=axes)
        return log

    ctx = LintContext(expected_permute_total=4,
                      expected_permutes={"data": 4})
    assert lint_log(sends([1, 3, 1, 3]), ctx).ok
    rep = lint_log(sends([1, 3, 1, 3, 1, 3]), ctx)
    assert _rules(rep) == ["PAIR-COUNT"]
    # a shift without its counterpart
    rep = lint_log(sends([1, 3, 1, 1]), LintContext())
    assert _rules(rep) == ["PAIR-COUNT"] and "unbalanced" in str(rep.errors)
    # an axis of 2: both directions go to one peer
    assert lint_log(sends([1, 1]), LintContext()).ok


def test_pair_count_all_to_all_total():
    log = CommLog()
    for _ in range(4):
        _coll(log, "all-to-all", 64, axes=("model",))
    assert lint_log(log, LintContext(expected_a2a_total=4)).ok
    assert _rules(lint_log(log, LintContext(expected_a2a_total=8))) == [
        "PAIR-COUNT"]


def test_bucket_order_reads_the_issue_order():
    log = CommLog()
    for n in (53, 37, 23, 11):
        _coll(log, "all-reduce", n, async_op=True)
    assert lint_log(log, LintContext(
        expected_ar_elements=[53, 37, 23, 11])).ok
    rep = lint_log(log, LintContext(expected_ar_elements=[11, 23, 37, 53]))
    assert _rules(rep) == ["BUCKET-ORDER"]


def test_one_rs_one_ag_is_a_multiset():
    log = CommLog()
    for n in (64, 128, 64):
        _coll(log, "all-gather", n, async_op=True)
    ctx = LintContext(expected_ag_elements=[64, 128])
    rep = lint_log(log, ctx)
    assert _rules(rep) == ["ONE-RS-ONE-AG"]
    assert "surplus" in rep.errors[0].message


def test_wire_widen_compares_dtype_budgets():
    log = CommLog()
    _coll(log, "all-reduce", 576, dtype="f32")
    ctx = LintContext(wire_dtype_elements={"bf16": 512, "f32": 64})
    rep = lint_log(log, ctx)
    assert _rules(rep) == ["WIRE-WIDEN"] and "bf16" in rep.errors[0].message
    log = CommLog()
    _coll(log, "all-reduce", 512, dtype="bf16")
    _coll(log, "all-reduce", 64, dtype="f32")
    assert lint_log(log, ctx).ok


def test_no_overlap_window_needs_independent_compute():
    # issue, compute reading its output, wait: exposed
    log = CommLog()
    c = _coll(log, "all-gather", 64, async_op=True, writes=(5,))
    _op(log, reads=(5,), writes=(6,))
    log.add("wait", handle=c)
    assert _rules(lint_log(log, LintContext())) == ["NO-OVERLAP-WINDOW"]
    assert lint_log(log, LintContext(max_exposed_collectives=1)).ok
    assert lint_log(log, LintContext(max_exposed_collectives=None)).ok
    # independent compute in the window: hidden
    log = CommLog()
    c = _coll(log, "all-gather", 64, async_op=True, writes=(5,))
    _op(log, reads=(7,), writes=(8,))
    log.add("wait", handle=c)
    _op(log, reads=(5,), writes=(6,))
    assert lint_log(log, LintContext()).ok
    # a synchronous call has no window; scalar compute opens none
    log = CommLog()
    _coll(log, "all-reduce", 64, writes=(5,))
    _op(log, reads=(7,), writes=(8,))
    assert _rules(lint_log(log, LintContext())) == ["NO-OVERLAP-WINDOW"]
    # a log with no compute at all (a pure communication schedule) passes
    log = CommLog()
    _coll(log, "all-reduce", 64, writes=(5,))
    assert lint_log(log, LintContext()).ok


def test_ag_adjacency_counts_live_gathered_buffers():
    def schedule(gather_all):
        log = CommLog()
        layers = 4
        if gather_all:
            for i in range(layers):
                _coll(log, "all-gather", 64, writes=(100 + i,))
            for i in list(range(layers)) + list(reversed(range(layers))):
                _op(log, reads=(100 + i, 1), writes=(2,))
        else:
            for i in list(range(layers)) + list(reversed(range(layers))):
                buf = 200 + len(log)
                _coll(log, "all-gather", 64, writes=(buf,))
                # through a copy (an unpack) to the compute that reads it
                _op(log, reads=(buf,), writes=(buf + 1,), compute=False,
                    name="clone")
                _op(log, reads=(buf + 1, 1), writes=(2,))
        return log

    # the gathers are synchronous: no overlap is claimed
    ctx = LintContext(max_exposed_collectives=None,
                      extra={"fsdp_working_set": 2})
    assert lint_log(schedule(False), ctx).ok
    rep = lint_log(schedule(True), ctx)
    assert _rules(rep) == ["AG-ADJACENCY"]
    assert "4 gathered buffers" in rep.errors[0].message
    off = LintContext(max_exposed_collectives=None)    # no limit: off
    assert lint_log(schedule(True), off).ok


def test_donation_lost_compares_state_storages():
    log = CommLog()
    log.state_in, log.state_out = frozenset({1, 2}), frozenset({1, 2})
    ctx = LintContext(expect_donation=True)
    assert lint_log(log, ctx).ok
    log.state_out = frozenset({1, 3})
    assert _rules(lint_log(log, ctx)) == ["DONATION-LOST"]
    assert lint_log(log, LintContext()).ok


def test_record_logs_calls_waits_peers_and_ops(tmp_path):
    """On a fake group of 4: the calls are recorded with their group's
    axes and a send's peer, each handle's wait after the compute between,
    and the aten ops with the storages they read and write."""
    from repro_torch.core.halo import start_exchange
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh

    fake_group(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        x = torch.ones(8, 4)
        with record(mesh) as log:
            ex = start_exchange(x[:1], x[-1:], mesh, "model", True)
            y = x * 2.0
            lo, hi = ex.wait()
            z = torch.cat([lo, y, hi])
            dist.all_reduce(z, group=mesh.groups["data"])
    finally:
        dist.destroy_process_group()
    kinds = [e.kind for e in log if e.kind != "op"]
    assert kinds == ["send", "send", "recv", "recv", "wait", "wait",
                     "wait", "wait", "all-reduce"]
    sends = log.collectives(["send"])
    assert {e.peer for e in sends} == {1} and sends[0].axes == ("model",)
    ar = log.collectives(["all-reduce"])[0]
    assert ar.axes == ("data",) and ar.elements == 40 and ar.dtype == "f32"
    mul = next(e for e in log.ops() if e.name == "mul")
    cat = next(e for e in log.ops() if e.name == "cat")
    assert mul.compute and not cat.compute
    recv_bufs = set().union(*(e.writes for e in log.collectives(["recv"])))
    assert recv_bufs <= cat.reads and mul.writes <= cat.reads
    assert count_ops(log, "send") == 2 and count_ops(log, "mul") == 1
    summary = collective_summary(log)
    assert summary.by_kind()["collective-permute"][0] == 2
    assert collective_bytes(log) == summary.total_wire_bytes


# -------------------------------------------------------- (b) the targets
@pytest.mark.parametrize("name", lt.all_targets())
def test_canonical_target_lints_clean(name):
    rep = _report(name)
    assert rep.ok, rep.render()
    assert rep.n_collectives > 0


@pytest.mark.parametrize("name", lt.broken_targets())
def test_broken_target_trips_its_rules_and_no_other(name):
    rep = _report(name)
    assert not rep.ok
    assert tuple(_rules(rep)) == tuple(sorted(lt.TRIPS[name])), rep.render()


def test_targets_are_the_references_and_the_tp_pair():
    from repro.analysis import lint_targets as jlt

    assert len(lt.all_targets()) == 18
    assert set(lt.all_targets()) == set(jlt.TARGETS) | {"lm_tp_train"}
    assert len(lt.broken_targets()) == 8
    assert set(lt.broken_targets()) - set(jlt.BROKEN) == {
        "broken_tp_gather_all"}


# ---------------------------------- (c) the failing JAX tests' invariants
def test_two_phase_mutations_trip_wire_and_overlap_rules():
    assert "WIRE-WIDEN" in _rules(_report("broken_two_phase_grad_sync"))
    assert "NO-OVERLAP-WINDOW" in _rules(_report("broken_two_phase_heat2d"))
    assert _report("heat2d_1d").ok


@pytest.mark.parametrize("name,sends", [("halo1d", 4), ("halo2d", 8),
                                        ("halo3d", 12)])
def test_halo_scan_peeled_send_counts(name, sends):
    """2·axes·steps sends (rank 0 has two neighbours on every periodic
    axis), every halo read, 4 and 8 ranks."""
    log = _target(name).log
    assert len(log.collectives(["send"])) == sends
    assert len(log.collectives(["recv"])) == sends
    assert _report(name).ok


def test_unpeeled_drain_and_lost_donation_are_caught():
    rules = _rules(_report("broken_unpeeled_halo1d"))
    assert {"DEAD-DRAIN", "PAIR-COUNT"} <= set(rules)
    assert _rules(_report("broken_no_donate_halo1d")) == ["DONATION-LOST"]


def test_fsdp_step_one_rs_one_ag_per_buffer_in_schedule_order():
    tgt = _target("lm_fsdp_1d")
    ag = [e.elements for e in tgt.log.collectives(["all-gather"])]
    rs = [e.elements for e in tgt.log.collectives(["reduce-scatter"])]
    assert ag == tgt.ctx.expected_ag_elements
    assert rs == tgt.ctx.expected_rs_elements
    assert _report("lm_fsdp_1d").ok
    # a second gather of every buffer (the reference's double-gather
    # mutation) on the same log is caught
    doubled = CommLog(events=list(tgt.log.events)
                      + list(tgt.log.collectives(["all-gather"])))
    rep = lint_log(doubled, tgt.ctx)
    assert "ONE-RS-ONE-AG" in _rules(rep)


def test_fsdp_streaming_gather_adjacency():
    assert _report("lm_fsdp_streaming").ok
    assert _rules(_report("broken_gather_all_streaming")) == [
        "AG-ADJACENCY"]
    log = _target("lm_fsdp_streaming").log
    ags = [e.name for e in log if e.kind == "ag"]
    assert len(ags) == len(log.collectives(["all-gather"]))


def test_grad_sync_reverse_topo_issue_order():
    log = _target("grad_sync_1d").log
    assert [e.elements for e in log.collectives(["all-reduce"])] == [
        53, 37, 23, 11]
    assert _rules(_report("broken_tree_grad_sync")) == ["BUCKET-ORDER"]


def test_decode_tp_target_and_two_phase_fixture():
    assert _report("lm_decode_tp").ok
    rules = _rules(_report("broken_two_phase_decode_tp"))
    assert "NO-OVERLAP-WINDOW" in rules and "PAIR-COUNT" not in rules


def _cli(*args):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", "/")}
    return subprocess.run([sys.executable, "-m",
                           "repro_torch.analysis.schedule_lint", *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


def test_cli_json_artifact_and_exit_codes(tmp_path):
    out = tmp_path / "lint.json"
    res = _cli("-t", "halo1d,heat2d_1d", "--ranks", "4", "--json", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    payload = json.loads(out.read_text())
    assert payload["ok"] is True
    assert [t["target"] for t in payload["targets"]] == ["halo1d",
                                                         "heat2d_1d"]
    assert all(t["n_collectives"] > 0 for t in payload["targets"])
    assert payload["rules"] == sorted(RULES_BY_ID)
    res = _cli("-t", "broken_unpeeled_halo1d", "--ranks", "4")
    assert res.returncode == 1, res.stdout + res.stderr
    assert "DEAD-DRAIN" in res.stdout
    res = _cli("-t", "halo3d", "--ranks", "4")
    assert res.returncode != 0 and "8 ranks" in res.stderr


def test_cli_main_in_process(capsys, tmp_path):
    assert main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert all(n in listed for n in lt.all_targets() + lt.broken_targets())
    assert main(["-t", "grad_sync_1d", "-r", "BUCKET-ORDER"]) == 0
    assert main(["-t", "broken_tree_grad_sync", "-r", "BUCKET-ORDER"]) == 1
    with pytest.raises(SystemExit):
        main(["-r", "NO-SUCH-RULE"])


# ------------------------------------- (d) expectations against the JAX's
def test_send_totals_match_the_references_arithmetic():
    from repro.analysis import lint_targets as jlt

    periodic = {"halo1d": jlt.PERMUTES_HALO(1, 2),
                "halo2d": jlt.PERMUTES_HALO(2, 2),
                "halo3d": jlt.PERMUTES_HALO(3, 2),
                "rk3_1d": jlt.PERMUTES_RK3(1, 2),
                "rk3_2d": jlt.PERMUTES_RK3(2, 2)}
    for name, want in periodic.items():
        assert _target(name).ctx.expected_permute_total == want, name
    # non-periodic: rank 0 has one neighbour an axis, half the permutes
    ends = {"heat2d_1d": jlt.PERMUTES_HALO(1, 2),
            "heat2d_2d": jlt.PERMUTES_HALO(2, 2),
            "heat2d_weighted": jlt.PERMUTES_HALO(2, 2),
            "hpccg_1d": jlt.PERMUTES_HPCCG(1, 2),
            "hpccg_3d": jlt.PERMUTES_HPCCG(3, 2)}
    for name, want in ends.items():
        assert 2 * _target(name).ctx.expected_permute_total == want, name
    assert lt.A2AS_MOE(2) == jlt.A2AS_MOE(2)
    assert _target("lm_moe_ep").ctx.expected_a2a_total == jlt.A2AS_MOE(2)


def test_grad_sync_bucket_lists_match_the_references():
    from repro.analysis import lint_targets as jlt

    for order in ("reverse_topo", "tree"):
        assert lt.grad_sync_expected(order) == jlt._grad_sync_expected(order)
    assert lt.SYNC_TREE_SIZES == jlt._SYNC_TREE_SIZES
    assert lt.SYNC_TREE_LAYERS == jlt._SYNC_TREE_LAYERS


def _jax_model(**opts):
    from repro.config.registry import get_arch as jax_arch
    from repro.models.model import ModelOptions, build_model

    return build_model(jax_arch("qwen3-8b").reduced(), ModelOptions(**opts))


def test_fsdp_bucket_lists_and_budgets_match_the_references():
    from repro.analysis import lint_targets as jlt
    from repro.config.base import ParallelConfig as JPar
    from repro.core.overlap import fsdp_layout, fsdp_stream

    jm = _jax_model(attn_impl="dense")
    par = JPar(param_shard=True, remat="none")
    jl = fsdp_layout(jm.abstract_params(), 4, par.grad_buckets,
                     layers=jm.param_layers(), order=par.bucket_order)
    ctx = _target("lm_fsdp_1d").ctx
    assert ctx.expected_ag_elements == [g.padded for g in jl.groups]
    assert ctx.expected_rs_elements == [g.padded // 4
                                        for g in reversed(jl.groups)]
    budget = {}
    for g in jl.groups:
        dt = jlt.hlo_dtype(g.dtype)
        budget[dt] = budget.get(dt, 0) + g.padded // 4
    assert ctx.wire_dtype_elements == budget
    # streaming: one bucket a layer
    jm = _jax_model(attn_impl="dense", scan_layers=False, remat="full",
                    fused_xent=False)
    jl = fsdp_layout(jm.abstract_params(), 4, 8, layers=jm.param_layers(),
                     order="layer")
    js = fsdp_stream(jl, jm.param_layers(), ("data",))
    ctx = _target("lm_fsdp_streaming").ctx
    mid = [d for d in js.depths if d not in (0, max(js.depths))]
    assert ctx.expected_ag_elements == (
        [g.padded for g in jl.groups]
        + [g.padded for d in reversed(mid) for g in js.groups_at(d)])
    # the same depths in the same order; within a depth the port issues
    # the reduce-scatters in reversed layout order (grad_sync_fsdp's)
    want = [sorted(g.padded // 4 for g in js.groups_at(d))
            for d in reversed(js.depths)]
    got, k = [], 0
    for d in reversed(js.depths):
        n = len(js.groups_at(d))
        got.append(sorted(ctx.expected_rs_elements[k:k + n]))
        k += n
    assert got == want


def test_parameter_budget_matches_the_references():
    from repro.analysis import lint_targets as jlt
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model

    jm = _jax_model(attn_impl="dense")
    pm = build_model(get_arch("qwen3-8b").reduced(),
                     ModelOptions(attn_impl="dense"))
    assert lt.param_budget(pm) == jlt._param_budget(jm.abstract_params())
    assert _target("lm_hdot_1d").ctx.wire_dtype_elements == \
        lt.param_budget(pm)


def test_decode_send_total_matches_the_references():
    from repro.config.registry import get_arch as jax_arch
    from repro.models.decode_tp import expected_permute_total as jexp
    from repro_torch.config.registry import get_arch
    from repro_torch.models.decode_tp import expected_permute_total

    for dp, tp in ((1, 2), (2, 2), (1, 4)):
        assert expected_permute_total(get_arch("qwen3-8b").reduced(), 8, dp,
                                      tp) == jexp(
            jax_arch("qwen3-8b").reduced(), 8, dp, tp)
    tgt = _target("lm_decode_tp")
    assert len(tgt.log.collectives(["send"])) == \
        tgt.ctx.expected_permute_total > 0


# ------------------------------------------ (e) the TP step's gathers
def _peak(name):
    tgt = _target(name)
    spans = ag_live_spans(tgt.log, tgt.ctx)
    return max(sum(1 for _, s, e in spans if s <= start < e)
               for _, start, _ in spans)


def test_tp_train_gathers_per_layer_and_gather_all_does_not():
    tgt = _target("lm_tp_train")
    top, layer = lt.tp_gathers(tgt.log.step.plan)
    layers = len(tgt.log.step.plan.spec_tree["layers"])
    assert layers == 4 and layer > 0
    assert tgt.ctx.extra["fsdp_working_set"] == top + 2 * layer
    assert _peak("lm_tp_train") <= top + 2 * layer
    # gathering all: every layer's blocks live at once, into the backward
    assert _peak("broken_tp_gather_all") >= layers * layer > top + 2 * layer
    # the per-layer step gathers each layer's blocks twice (the forward
    # and the backward's recompute); the gather-all once
    data = lambda n: len([e for e in _target(n).log.collectives(
        ["all-gather"]) if e.axes == ("data",)])
    assert data("lm_tp_train") == top + 2 * layers * layer
    assert data("broken_tp_gather_all") == top + layers * layer

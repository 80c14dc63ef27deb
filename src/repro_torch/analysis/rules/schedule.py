"""Overlap-schedule rules: DEAD-DRAIN, PAIR-COUNT, NO-OVERLAP-WINDOW, the
port of ``repro/analysis/rules/schedule.py`` over one rank's issue-order
log.

They encode the HDOT claims about the halo-exchange schedule: no exchange
is launched whose result nobody computes on (the drain-step bug), each
mesh axis exchanges exactly one forward and one backward message per step
(over-decomposition did not duplicate traffic), and every collective that
claims overlap has compute that does not depend on it between its issue
and its wait (the port's structural overlap: the message flies while that
compute runs).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

from repro_torch.analysis.comm_log import CommLog
from repro_torch.analysis.rules.base import (Finding, LintContext, Rule,
                                             sized_collectives)


class DeadDrainRule(Rule):
    """A received halo buffer that no later op reads, and that the step
    does not return, is a dead drain exchange: pure wire traffic with no
    consumer. An unpeeled halo scan issues the last step's exchange whose
    halos no step ever reads."""
    id = "DEAD-DRAIN"
    fix_hint = ("peel the final exchange out of the steady-state loop (the "
                "last step computes on the halos in flight and sends "
                "nothing: core.halo.halo_scan_nd)")

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        readers = log.readers()
        out = []
        for e in log.collectives(["recv"]):
            if any(i > e.index for s in e.writes
                   for i in readers.get(s, ())):
                continue
            if e.writes & log.outputs:
                continue
            out.append(self.event_finding(
                f"received halo from rank {e.peer} is dead: no later op "
                f"reads it and the step does not return it", e))
        return out


class PairCountRule(Rule):
    """Sends per mesh axis must match the schedule's arithmetic: one
    forward and one backward message per axis per step for a peeled halo
    scan (the peeled drain step sends none). More sends means duplicated
    halo traffic; fewer a missing exchange. Each ring is balanced by its
    reverse: on an axis this rank sends to two peers, it sends to each as
    often. With ``expected_a2a_total`` the MoE EP all-to-alls are counted
    the same way: 2Q (dispatch and combine over Q capacity slices) a MoE
    layer forward and 2Q backward."""
    id = "PAIR-COUNT"
    fix_hint = ("one send per neighbour per axis per step: check the "
                "steps, drain peeling, and that over-decomposition shares "
                "one exchange across interior chunks")

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        sends = log.collectives(["send"])
        out: List[Finding] = []
        anchor = sends[0] if sends else None

        def report(msg, e=None, **kw):
            out.append(self.event_finding(msg, e, **kw) if e is not None
                       else self.finding(msg, **kw))

        if ctx.expected_permute_total is not None \
                and len(sends) != ctx.expected_permute_total:
            report(f"expected {ctx.expected_permute_total} sends for "
                   f"{ctx.target or 'schedule'}, found {len(sends)}", anchor)
        per_axis: Dict[str, int] = Counter(",".join(e.axes) for e in sends)
        for axis, n in sorted((ctx.expected_permutes or {}).items()):
            if per_axis.get(axis, 0) != n:
                report(f"expected {n} sends on axis {axis!r}, found "
                       f"{per_axis.get(axis, 0)}", anchor)
        if ctx.expected_a2a_total is not None:
            a2as = log.collectives(["all-to-all"])
            if len(a2as) != ctx.expected_a2a_total:
                report(f"expected {ctx.expected_a2a_total} all-to-alls for "
                       f"{ctx.target or 'schedule'} (2 x a2a_chunks a MoE "
                       f"layer, forward and backward), found {len(a2as)}",
                       a2as[0] if a2as else None,
                       fix_hint=("a2a_scan issues exactly dispatch + "
                                 "combine a slice: check moe_a2a_chunks "
                                 "and that remat does not re-run the MoE "
                                 "block"))
        by_axis: Dict[str, Counter] = {}
        for e in sends:
            by_axis.setdefault(",".join(e.axes), Counter())[e.peer] += 1
        for axis, peers in sorted(by_axis.items()):
            if len(set(peers.values())) > 1:
                e = next(s for s in sends if ",".join(s.axes) == axis)
                report(f"unbalanced halo exchange on axis {axis!r}: sends "
                       f"by peer {dict(sorted(peers.items()))}; a shift "
                       f"without its counterpart is a lost halo", e)
        return out


class NoOverlapWindowRule(Rule):
    """A collective with no independent compute between its issue and its
    wait cannot be hidden: every op in between either produces what it
    sends or consumes what it receives, or there is none (a synchronous
    call, or a wait right after the issue). That is the two-phase shape
    (exchange -> barrier -> compute). HDOT schedules keep interior compute
    that reads none of the collective's output storages in the window.
    ``max_exposed_collectives`` allows the schedule's own fills, drains
    and synchronous calls."""
    id = "NO-OVERLAP-WINDOW"
    fix_hint = ("issue the collective asynchronously before compute that "
                "does not read its result, and wait after it (over-"
                "decompose: boundary strips consume the halos, interior "
                "chunks run in the window)")

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        if ctx.max_exposed_collectives is None or not log.ops(compute=True):
            return []
        waits = log.wait_of()
        events = log.events
        exposed = []
        for c in sized_collectives(
                log, ["send", "recv", "all-reduce", "all-gather",
                      "reduce-scatter", "all-to-all"], ctx):
            end = waits.get(c.index, len(events)) if c.async_op \
                else c.index + 1
            if not any(e.kind == "op" and e.compute
                       and e.elements > ctx.scalar_elements
                       and not (e.reads & c.writes)
                       for e in events[c.index + 1:end]):
                exposed.append(c)
        if len(exposed) <= ctx.max_exposed_collectives:
            return []
        return [self.event_finding(
            f"{c.kind} has no independent compute between its issue and "
            f"its wait: nothing can hide it ({len(exposed)} exposed, "
            f"{ctx.max_exposed_collectives} allowed)", c) for c in exposed]

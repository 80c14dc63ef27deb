"""Grad-sync bucket rules: BUCKET-ORDER, ONE-RS-ONE-AG, AG-ADJACENCY,
DONATION-LOST, the port of ``repro/analysis/rules/buckets.py`` over one
rank's issue-order log.

Expectations come from the schedule code the port runs (``make_buckets``,
``fsdp_layout``, the TP plan), fed in through :class:`LintContext`. The
rules check the log against them:

* exactly one reduce-scatter and one all-gather per (bucket x dtype) flat
  buffer (nothing issued twice, no buffer split);
* reduce-scatters and all-reduces issued in reverse-topological order
  (the last backward bucket first: its gradient is ready first) and
  all-gathers forward. The log is the issue order itself;
* at most a working set of gathered buffers live at once;
* the step's state updated in place.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.comm_log import CommLog, Event
from repro_torch.analysis.rules.base import (Finding, LintContext, Rule,
                                             sized_collectives)


class OneRsOneAgRule(Rule):
    """Each FSDP (bucket x dtype) buffer crosses the wire exactly once per
    direction: one reduce-scatter for its gradient, one all-gather for its
    parameters. A duplicate means a collective issued twice (twice the
    wire traffic); a missing one a bucket that fell out of sync. Compared
    as multisets of result element counts."""
    id = "ONE-RS-ONE-AG"
    fix_hint = ("one flat buffer per (bucket, dtype): check FsdpLayout "
                "grouping and that grad_sync_fsdp / fsdp_all_gather are "
                "called once per buffer per step")

    def _diff(self, ops: Sequence[Event], expected: Optional[List[int]],
              kind: str) -> List[Finding]:
        if expected is None:
            return []
        got = Counter(e.elements for e in ops)
        want = Counter(expected)
        out: List[Finding] = []
        for size in sorted(got - want):
            e = next(e for e in ops if e.elements == size)
            out.append(self.event_finding(
                f"surplus {kind} for a {size}-element buffer: {got[size]} "
                f"found, {want[size]} expected", e))
        for size in sorted(want - got):
            out.append(self.finding(
                f"missing {kind} for a {size}-element buffer "
                f"({want[size]} expected, {got[size]} found)"))
        return out

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        rs = sized_collectives(log, ["reduce-scatter"], ctx)
        ag = sized_collectives(log, ["all-gather"], ctx)
        return (self._diff(rs, ctx.expected_rs_elements, "reduce-scatter")
                + self._diff(ag, ctx.expected_ag_elements, "all-gather"))


class BucketOrderRule(Rule):
    """Bucket collectives must be issued in schedule order:
    reduce-scatters (and plain-DP all-reduces) reverse-topological, the
    last backward bucket first, so its collective overlaps the rest of the
    backward, and all-gathers forward, in the order the forward consumes
    them. A ``make_buckets(order='tree')`` regression trips it."""
    id = "BUCKET-ORDER"
    fix_hint = ("issue grad collectives in reverse-topological bucket "
                "order (make_buckets(..., order='reverse_topo')); "
                "all-gathers in forward order")

    def _check_seq(self, ops: Sequence[Event], expected: Optional[List[int]],
                   kind: str) -> List[Finding]:
        if expected is None:
            return []
        got = [e.elements for e in ops]
        if sorted(got) != sorted(expected):
            return []  # wrong population: ONE-RS-ONE-AG reports it
        if got == expected:
            return []
        return [self.event_finding(
            f"{kind} issue order {got} does not match schedule order "
            f"{expected}", ops[0])]

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        out = self._check_seq(sized_collectives(log, ["reduce-scatter"], ctx),
                              ctx.expected_rs_elements, "reduce-scatter")
        out += self._check_seq(sized_collectives(log, ["all-gather"], ctx),
                               ctx.expected_ag_elements, "all-gather")
        out += self._check_seq(sized_collectives(log, ["all-reduce"], ctx),
                               ctx.expected_ar_elements, "all-reduce")
        return out


def ag_live_spans(log: CommLog, ctx: LintContext
                  ) -> List[Tuple[Event, int, int]]:
    """Live span of every sized all-gather's result (over
    ``ctx.extra["ag_axes"]`` when given): ``(ag, issue index, index of the
    last compute op reading it)``, followed through the ops that only move
    data (unpacking, casts, copies: their outputs carry the buffer on)."""
    axes = ctx.extra.get("ag_axes")
    readers = log.readers()
    events = log.events
    spans = []
    for ag in sized_collectives(log, ["all-gather"], ctx):
        if axes is not None and not set(ag.axes) <= set(axes):
            continue
        carried, frontier, last = set(ag.writes), list(ag.writes), None
        while frontier:
            s = frontier.pop()
            for i in readers.get(s, ()):
                if i <= ag.index:
                    continue
                e = events[i]
                if e.compute:
                    last = i if last is None else max(last, i)
                else:
                    for w in e.writes - carried:
                        carried.add(w)
                        frontier.append(w)
        if last is not None:
            spans.append((ag, ag.index, last))
    return spans


class AgAdjacencyRule(Rule):
    """Working-set bound of a per-layer gather schedule (streaming ZeRO-3,
    the TP step's data-axis gathers): a gathered buffer is live from its
    gather to its last compute consumer, and at most
    ``ctx.extra['fsdp_working_set']`` may be live at once. The per-layer
    schedules keep it because the backward regathers each layer's blocks
    inside its remat region, so every forward gather dies within its own
    layer. A top-of-step gather-all keeps every gathered buffer live into
    the backward (the weights are read again there), so all of them
    overlap and this rule trips."""
    id = "AG-ADJACENCY"
    fix_hint = ("gather each layer's blocks at the consuming layer, inside "
                "its remat region, and regather in the backward "
                "(core.overlap.FsdpStream; the TP step's TPPlan.layer_view) "
                "instead of gathering the whole model at the top of the "
                "step")

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        limit = ctx.extra.get("fsdp_working_set")
        if limit is None:
            return []
        spans = ag_live_spans(log, ctx)
        peak, peak_ag = 0, None
        for ag, start, _ in spans:   # the live count only rises at a gather
            live = sum(1 for _, s, e in spans if s <= start < e)
            if live > peak:
                peak, peak_ag = live, ag
        if peak <= limit:
            return []
        return [self.event_finding(
            f"{peak} gathered buffers live at once (working-set limit "
            f"{limit}): gathered parameters survive to backward consumers "
            f"instead of dying within their layer, a top-of-step "
            f"gather-all schedule", peak_ag)]


class DonationLostRule(Rule):
    """The train steps and the lint's solver steps update their state in
    place: the state's storages after the step are the ones it was given.
    A step that hands back new storages (a wrapper that copied its state,
    an out-of-place update) holds the old and the new state at once, and
    its peak memory doubles on the state."""
    id = "DONATION-LOST"
    fix_hint = ("update the state in place (the optimizer writes into the "
                "parameter and moment storages; a solver step copies its "
                "result into its state) and return those tensors")

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        if not ctx.expect_donation:
            return []
        if log.state_in and log.state_out == log.state_in:
            return []
        fresh = len((log.state_out or frozenset())
                    - (log.state_in or frozenset()))
        return [self.finding(
            f"the step's state is not updated in place: {fresh} of its "
            f"storages after the step are new")]

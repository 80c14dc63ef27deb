"""WIRE-WIDEN: gradients crossing the wire wider than the parameter spec:
the port of ``repro/analysis/rules/wire.py``.

A naive gradient sync (two_phase's single concatenated all-reduce) moves
every gradient in the dtype the leaves promote to: bf16 gradients cross
the interconnect as f32, twice the bytes for no fidelity the optimizer can
use. The HDOT buckets reduce each leaf in its own dtype.

The rule compares, per wire dtype, the elements moved by the reduction
collectives (all-reduce, reduce-scatter) against the parameter spec's
budget for that dtype.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from repro_torch.analysis.comm_log import DTYPE_BYTES, CommLog
from repro_torch.analysis.rules.base import (Finding, LintContext, Rule,
                                             sized_collectives)


class WireWidenRule(Rule):
    """Reduction collectives moving more elements of a dtype than the
    parameter spec budgets for it are carrying upcast gradients (the
    two_phase concatenated all-reduce takes the promoted dtype)."""
    id = "WIRE-WIDEN"
    fix_hint = ("sync gradients per dtype (HDOT buckets keep bf16 grads on "
                "a bf16 wire); for a narrower wire use the error-feedback "
                "codecs of optim/compression.py (bf16/fp8/int8)")

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        budget = ctx.wire_dtype_elements
        if budget is None:
            return []
        moved: Dict[str, int] = defaultdict(int)
        anchors = {}
        for e in sized_collectives(log, ["all-reduce", "reduce-scatter"],
                                   ctx):
            moved[e.dtype] += e.elements
            prev = anchors.get(e.dtype)
            if prev is None or e.elements > prev.elements:
                anchors[e.dtype] = e
        out: List[Finding] = []
        for dt, n in sorted(moved.items()):
            allowed = budget.get(dt, 0) + ctx.wire_pad_slack
            if n <= allowed:
                continue
            narrower = [d for d in budget
                        if DTYPE_BYTES.get(d, 0) < DTYPE_BYTES.get(dt, 0)
                        and budget[d] > 0]
            hint = (f" (parameter spec holds {sorted(budget.items())}; "
                    f"likely upcast from {'/'.join(sorted(narrower))})"
                    if narrower else "")
            out.append(self.event_finding(
                f"reduction collectives move {n} {dt} elements but the "
                f"parameter spec budgets {allowed}: gradients cross the "
                f"wire widened{hint}", anchors[dt]))
        return out

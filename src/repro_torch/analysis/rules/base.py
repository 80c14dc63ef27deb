"""Finding / context / rule base types for the schedule linter: the port
of ``repro/analysis/rules/base.py``, over a :class:`~repro_torch.analysis.
comm_log.CommLog` in place of an HLO module (a log index takes the place
of the HLO line)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.comm_log import CommLog, Event


class Severity:
    ERROR = "error"      # schedule invariant broken: CI fails
    WARNING = "warning"  # suspicious but not provably wrong
    INFO = "info"        # annotation only (e.g. wire-bytes report)

    ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclass
class Finding:
    """One structured lint finding: which rule, where, what, how to fix.
    `op` is the event's kind (or aten op), `computation` the mesh axes of
    its group, `index` its place in the log."""
    rule: str
    severity: str
    message: str
    fix_hint: str
    op: str = ""
    computation: str = ""
    index: int = 0
    wire_bytes: Optional[float] = None
    snippet: str = ""

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule, "severity": self.severity,
            "message": self.message, "fix_hint": self.fix_hint,
            "op": self.op, "computation": self.computation,
            "index": self.index,
        }
        if self.wire_bytes is not None:
            d["wire_bytes"] = round(self.wire_bytes, 1)
        if self.snippet:
            d["snippet"] = self.snippet
        return d

    def __str__(self) -> str:
        loc = f"{self.computation or '-'}/{self.op}" if self.op else "<log>"
        wire = (f" [{self.wire_bytes / 1e3:.1f} kB wire]"
                if self.wire_bytes is not None else "")
        return (f"{self.severity.upper():7s} {self.rule:18s} {loc}"
                f" (event {self.index}){wire}\n"
                f"        {self.message}\n        fix: {self.fix_hint}")


@dataclass
class LintContext:
    """What the logged step is *supposed* to look like.

    Filled by the target factory (``lint_targets.py``) from the schedule
    code the port runs (``make_buckets``, ``FsdpLayout``, the halo
    arithmetic, ``decode_tp.expected_permute_total``), so the expectations
    cannot drift from the implementation. The fields are the JAX
    package's; counts are of this rank's log.
    """
    target: str = ""
    # PAIR-COUNT: sends per mesh axis, and in all
    expected_permutes: Optional[Dict[str, int]] = None
    expected_permute_total: Optional[int] = None
    # PAIR-COUNT: all-to-alls (the MoE EP dispatch and combine: 2Q a MoE
    # layer forward and 2Q backward)
    expected_a2a_total: Optional[int] = None
    # BUCKET-ORDER / ONE-RS-ONE-AG: per-(bucket x dtype) result elements in
    # issue order, from FsdpLayout / make_buckets
    expected_rs_elements: Optional[List[int]] = None
    expected_ag_elements: Optional[List[int]] = None
    expected_ar_elements: Optional[List[int]] = None
    # WIRE-WIDEN: the parameter spec's elements per wire dtype (HLO names:
    # "f32", "bf16")
    wire_dtype_elements: Optional[Dict[str, int]] = None
    wire_pad_slack: int = 0
    # NO-OVERLAP-WINDOW: collectives allowed no window (a pipeline fill, a
    # drain, a backward the schedule issues synchronously); None: the step
    # claims no overlap, and the rule is off
    max_exposed_collectives: Optional[int] = 0
    # DONATION-LOST: the step updates its state in place
    expect_donation: bool = False
    # collectives of <= this many elements are bookkeeping (a loss mean, a
    # grad-norm scalar), skipped by the traffic rules; compute of <= this
    # many elements opens no overlap window
    scalar_elements: int = 8
    # extra["fsdp_working_set"]: AG-ADJACENCY's limit on gathered buffers
    # live at once; extra["ag_axes"]: the mesh axes whose all-gathers it
    # counts (default: every all-gather)
    extra: Dict[str, object] = field(default_factory=dict)


def annotate_wire_bytes(e: Event) -> Optional[float]:
    """memtraffic ring-model wire bytes of a collective event."""
    return e.wire_bytes if e.is_collective else None


class Rule:
    """Base class: subclasses set id/severity/fix_hint and implement check."""
    id: str = ""
    severity: str = Severity.ERROR
    fix_hint: str = ""

    def check(self, log: CommLog, ctx: LintContext) -> List[Finding]:
        raise NotImplementedError

    def finding(self, message: str, *, op: str = "", computation: str = "",
                index: int = 0, wire_bytes: Optional[float] = None,
                snippet: str = "", fix_hint: str = "",
                severity: str = "") -> Finding:
        return Finding(rule=self.id, severity=severity or self.severity,
                       message=message, fix_hint=fix_hint or self.fix_hint,
                       op=op, computation=computation, index=index,
                       wire_bytes=wire_bytes, snippet=snippet)

    def event_finding(self, message: str, e: Event, **kw) -> Finding:
        return self.finding(message, op=e.name or e.kind,
                            computation=",".join(e.axes), index=e.index,
                            wire_bytes=annotate_wire_bytes(e),
                            snippet=str(e)[:160], **kw)


def sized_collectives(log: CommLog, kinds: Sequence[str],
                      ctx: LintContext) -> List[Event]:
    """The log's collectives of the given kinds, bookkeeping skipped."""
    return [e for e in log.collectives(kinds)
            if e.elements > ctx.scalar_elements]

"""Schedule linter: the port of ``repro/analysis/hlo_lint.py``.

The JAX package proves the HDOT overlap shape on the pre-optimization HLO
of its lowered programs. The port makes no HLO; it proves the same
invariants (peeled drains, one message per neighbour per axis per step,
reverse-topological bucket issue, one reduce-scatter and one all-gather
per ZeRO-3 buffer, gradients on the wire at parameter width, a per-layer
gather working set, state updated in place, compute in every overlap
window) on the issue-order log of one rank's ``torch.distributed`` calls
and the aten ops between them (``analysis/comm_log.py``), checked by the
rules of ``analysis/rules/``.

Usage:
    python -m repro_torch.analysis.schedule_lint                # every canonical target
    python -m repro_torch.analysis.schedule_lint -t halo1d,rk3_2d --json findings.json
    python -m repro_torch.analysis.schedule_lint --list
    python -m repro_torch.analysis.schedule_lint -t lm_tp_train --device cuda

Each target runs on rank 0 of a fake process group of 4 or 8 ranks (at
most ``--ranks``), on small real tensors on ``--device`` (the CPU unless
asked), in this process. Exit codes are the reference's: 0 when every
target passes, 1 when one carries an error finding.

Library use (tests, the 4-card runs):
    from repro_torch.analysis.comm_log import record
    from repro_torch.analysis.schedule_lint import lint_log
    with record(mesh) as log:
        step(...)
    report = lint_log(log, ctx)
    assert report.ok, report.render()
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.analysis.comm_log import CommLog, collective_bytes
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID, LintContext, Severity
from repro_torch.analysis.rules.base import Finding, Rule


@dataclass
class LintReport:
    target: str
    findings: List[Finding] = field(default_factory=list)
    n_collectives: int = 0
    n_events: int = 0
    wire_bytes: float = 0.0          # ring-model total of the log

    @property
    def ok(self) -> bool:
        return not any(f.severity == Severity.ERROR for f in self.findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.ERROR]

    def to_dict(self) -> dict:
        return {
            "target": self.target, "ok": self.ok,
            "n_collectives": self.n_collectives, "n_events": self.n_events,
            "wire_bytes": round(self.wire_bytes, 1),
            "findings": [f.to_dict() for f in self.findings],
        }

    def render(self) -> str:
        head = (f"{'PASS' if self.ok else 'FAIL'} {self.target:28s} "
                f"({self.n_collectives} collectives, {self.n_events} "
                f"events, {self.wire_bytes / 1e3:.1f} kB wire)")
        if not self.findings:
            return head
        return head + "\n" + "\n".join(str(f) for f in self.findings)


def lint_log(log: CommLog, ctx: Optional[LintContext] = None,
             rules: Optional[Sequence[Rule]] = None,
             target: str = "") -> LintReport:
    """Run the rule set against one rank's log."""
    ctx = ctx or LintContext()
    report = LintReport(target=target or ctx.target or "log",
                        n_collectives=len(log.collectives()),
                        n_events=len(log), wire_bytes=collective_bytes(log))
    for rule in (rules if rules is not None else ALL_RULES):
        report.findings.extend(rule.check(log, ctx))
    report.findings.sort(key=lambda f: (Severity.ORDER.get(f.severity, 9),
                                        f.rule, f.index))
    return report


def lint_target(name: str, rules: Optional[Sequence[Rule]] = None,
                device: str = "cpu", ranks: int = 8) -> LintReport:
    """Run one target (``lint_targets``) on a fake group and lint it."""
    from repro_torch.analysis import lint_targets

    tgt = lint_targets.build(name, device=device, ranks=ranks)
    return lint_log(tgt.log, tgt.ctx, rules=rules, target=name)


# ------------------------------------------------------------------- CLI
def _select_rules(only: Optional[str]) -> Optional[List[Rule]]:
    if not only:
        return None
    out = []
    for rid in only.split(","):
        rid = rid.strip()
        if rid not in RULES_BY_ID:
            raise SystemExit(f"unknown rule {rid!r}; known: "
                             f"{', '.join(sorted(RULES_BY_ID))}")
        out.append(RULES_BY_ID[rid])
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.schedule_lint",
        description="Lint the port's HDOT schedules on their issue-order "
                    "logs.")
    ap.add_argument("-t", "--targets", default="",
                    help="comma-separated target names (default: every "
                         "canonical target)")
    ap.add_argument("-r", "--rules", default="",
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the findings report as JSON")
    ap.add_argument("--ranks", type=int, default=8,
                    help="the most ranks a target's fake group may have "
                         "(default 8)")
    ap.add_argument("--device", default="cpu",
                    help="where the targets' tensors live (default cpu)")
    ap.add_argument("--list", action="store_true",
                    help="list targets and rules, then exit")
    args = ap.parse_args(argv)

    from repro_torch.analysis import lint_targets

    if args.list:
        print("targets:")
        for name, doc in lint_targets.describe():
            print(f"  {name:28s} {doc}")
        print("broken (each trips its rule):")
        for name, doc in lint_targets.describe(broken=True):
            print(f"  {name:28s} {doc}")
        print("rules:")
        for rule in ALL_RULES:
            print(f"  {rule.id:18s} [{rule.severity}] "
                  f"{(rule.__doc__ or '').strip().splitlines()[0]}")
        return 0

    names = ([n.strip() for n in args.targets.split(",") if n.strip()]
             or lint_targets.all_targets())
    rules = _select_rules(args.rules)
    reports = []
    for name in names:
        report = lint_target(name, rules=rules, device=args.device,
                             ranks=args.ranks)
        reports.append(report)
        print(report.render(), flush=True)
    n_err = sum(len(r.errors) for r in reports)
    print(f"linted {len(reports)} targets: "
          f"{sum(r.ok for r in reports)} pass, "
          f"{sum(not r.ok for r in reports)} fail ({n_err} errors)")
    if args.json:
        payload = {
            "targets": [r.to_dict() for r in reports],
            "ok": all(r.ok for r in reports),
            "rules": sorted(RULES_BY_ID),
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json}")
    return 0 if all(r.ok for r in reports) else 1


if __name__ == "__main__":
    raise SystemExit(main())

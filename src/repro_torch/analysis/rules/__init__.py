"""Lint rule registry for the schedule linter: the port of
``repro/analysis/rules/__init__.py``.

Each rule encodes one HDOT overlap invariant as a check over one rank's
issue-order log (``analysis/comm_log.py``). Rules are pure: log + context
in, structured findings out. Register new rules by appending to
``ALL_RULES``.
"""
from repro_torch.analysis.rules.base import (Finding, LintContext, Rule,
                                             Severity, annotate_wire_bytes)
from repro_torch.analysis.rules.buckets import (AgAdjacencyRule,
                                                BucketOrderRule,
                                                DonationLostRule,
                                                OneRsOneAgRule)
from repro_torch.analysis.rules.schedule import (DeadDrainRule,
                                                 NoOverlapWindowRule,
                                                 PairCountRule)
from repro_torch.analysis.rules.wire import WireWidenRule

ALL_RULES = (
    DeadDrainRule(),
    PairCountRule(),
    BucketOrderRule(),
    OneRsOneAgRule(),
    WireWidenRule(),
    NoOverlapWindowRule(),
    AgAdjacencyRule(),
    DonationLostRule(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}

__all__ = [
    "ALL_RULES", "RULES_BY_ID", "Finding", "LintContext", "Rule", "Severity",
    "annotate_wire_bytes", "DeadDrainRule", "PairCountRule", "BucketOrderRule",
    "OneRsOneAgRule", "WireWidenRule", "NoOverlapWindowRule",
    "AgAdjacencyRule", "DonationLostRule",
]

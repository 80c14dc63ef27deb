"""Fault-tolerance controller: restart-on-failure and straggler-absorbing
data reassignment, the port of ``repro/runtime/ft.py``.

A failed step must be retryable without losing more than
``checkpoint_every`` steps: restore the latest atomic checkpoint and
continue from its data step, which works because the data pipeline is a
pure function of the step index.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence

log = logging.getLogger(__name__)


def reassign_host_shards(num_hosts: int, failed: Sequence[int]
                         ) -> Dict[int, List[int]]:
    """Straggler/failure mitigation at the data level: the slices owned by
    failed (or persistently slow) hosts are redistributed round-robin over
    the survivors. Over-decomposition is what makes a slice reassignable
    without data movement: any host can compute any slice.

    Returns {surviving_host: [slice ids it now serves]}."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    failed_set = set(failed)
    bad = sorted(h for h in failed_set if not 0 <= h < num_hosts)
    if bad:
        raise ValueError(
            f"failed host ids {bad} out of range for num_hosts={num_hosts}")
    survivors = [h for h in range(num_hosts) if h not in failed_set]
    if not survivors:
        raise RuntimeError("no surviving hosts")
    out: Dict[int, List[int]] = {h: [h] for h in survivors}
    for i, lost in enumerate(sorted(failed_set)):
        out[survivors[i % len(survivors)]].append(lost)
    return out


class FaultTolerantRunner:
    """Runs a trainer (``runtime.trainer.Trainer``) to a step count,
    restarting from the latest checkpoint on any exception."""

    def __init__(self, trainer_factory: Callable[[], object],
                 max_restarts: int = 3):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.trainer_factory = trainer_factory
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, total_steps: int,
            failure_hook: Optional[Callable[[int], None]] = None):
        """Run to `total_steps`, restarting from the latest checkpoint on any
        exception (up to max_restarts). Returns the final trainer."""
        trainer = self.trainer_factory()
        while True:
            try:
                if trainer.params is None:
                    trainer.restore_if_available()
                remaining = total_steps - trainer.step
                if remaining <= 0:
                    return trainer
                trainer.train(remaining, failure_hook=failure_hook)
                return trainer
            except Exception as e:  # noqa: BLE001 - controller must catch all
                self.restarts += 1
                log.warning("step failed (%s); restart %d/%d",
                            e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                # fresh trainer: re-reads the latest atomic checkpoint
                trainer = self.trainer_factory()

"""Fault tolerance: straggler-absorbing data reassignment.

The port's own copy of ``reassign_host_shards`` (pure Python, as in the JAX
package); the restart controller waits for the training slice.
"""
from __future__ import annotations

from typing import Dict, List, Sequence


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

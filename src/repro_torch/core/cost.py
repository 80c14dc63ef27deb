"""Measured-cost model for dynamic re-partitioning (paper §3.2's load-balance
claim, made adaptive).

HDOT's interior chunk grid absorbs imbalance only if the cut tracks where the
time actually goes. This module is the measurement half: per-chunk wall-clock
is recorded by the caller, an EMA smooths transient noise, and
:meth:`CostModel.weights_along` turns the chunk EMAs back into per-dim
per-cell cost profiles — exactly the `weights=` input
:func:`repro_torch.core.domain.split_ranges` cuts on. Pure python: the port's
own copy of ``repro.core.cost``, kept line for line.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple


class CostModel:
    """Per-key EMA of measured cost, normalized per cell.

    Keys are arbitrary hashables — the re-cut driver uses interior-chunk grid
    indices ``(i, j, ...)``, the straggler drill uses ``(worker_id,)``.
    Normalizing by `cells` before the EMA keeps the estimate stable across
    re-cuts that change a chunk's size: what we track is the *rate* (seconds
    per cell), which is a property of the owner, not of the current cut.
    """

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._ema: Dict[object, float] = {}
        self._count: Dict[object, int] = {}

    def record(self, key, seconds: float, cells: int = 1) -> float:
        """Fold one wall-clock observation into the key's per-cell EMA and
        return the updated estimate."""
        if seconds < 0:
            raise ValueError(f"seconds must be >= 0, got {seconds}")
        per_cell = seconds / max(int(cells), 1)
        prev = self._ema.get(key)
        cur = per_cell if prev is None else (
            self.alpha * per_cell + (1.0 - self.alpha) * prev)
        self._ema[key] = cur
        self._count[key] = self._count.get(key, 0) + 1
        return cur

    def ema(self, key, default: Optional[float] = None) -> Optional[float]:
        return self._ema.get(key, default)

    def observations(self, key) -> int:
        return self._count.get(key, 0)

    def __len__(self) -> int:
        return len(self._ema)

    def mean_rate(self) -> float:
        """Mean per-cell rate over every recorded key (the prior used for
        chunks that have not been measured yet)."""
        if not self._ema:
            return 1.0
        return sum(self._ema.values()) / len(self._ema)

    def weights_along(self, per_dim_ranges: Sequence[Sequence[Tuple[int, int]]]
                      ) -> Tuple[Tuple[float, ...], ...]:
        """Marginalize the chunk EMAs into per-dim per-cell cost profiles.

        `per_dim_ranges` is the CURRENT cut: for each dim, the list of
        (start, stop) chunk ranges, so chunk ``(i0, ..., iN)`` covers
        ``per_dim_ranges[d][id]`` along dim d and its EMA is looked up under
        that grid-index key. Each dim's profile assigns every cell the mean
        per-cell rate of the chunks whose range covers it (averaging over the
        other dims); unmeasured chunks fall back to :meth:`mean_rate`. The
        result plugs straight into ``interior_boxes(..., weights=...)`` for
        the next cut."""
        prior = self.mean_rate()
        ndim = len(per_dim_ranges)
        extents = [max(b for _, b in rng) if rng else 0
                   for rng in per_dim_ranges]
        acc = [[0.0] * e for e in extents]
        cnt = [[0] * e for e in extents]
        for idx in itertools.product(*[range(len(r)) for r in per_dim_ranges]):
            rate = self._ema.get(tuple(idx), prior)
            for d in range(ndim):
                a, b = per_dim_ranges[d][idx[d]]
                for c in range(a, b):
                    acc[d][c] += rate
                    cnt[d][c] += 1
        return tuple(
            tuple(acc[d][c] / cnt[d][c] if cnt[d][c] else prior
                  for c in range(extents[d]))
            for d in range(ndim))

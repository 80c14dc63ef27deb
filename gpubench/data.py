"""The one traffic generator: token batches for a training mix, made from
the run's seed and the mix's parameters (``traffic/<mix>.json``).

It is the benchmark's own copy of the program's synthetic LM stream (a
noisy affine next-token process: ``x[t+1] = (a * x[t] + b) % V``, and with
probability `noise` a uniformly drawn token instead), addressed
statelessly by (seed, step). Every row of a step starts from its own
token (a permutation of the vocabulary), so the rows of a batch all
differ. The trainer reads it through ``batch_at`` and ``host_slice``, as
it reads the program's own dataset; the program receives only these
arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int
    noise: float = 0.1
    a: int = 1
    b: int = 7

    @classmethod
    def from_traffic(cls, traffic: Dict, vocab_size: int,
                     seed: int) -> "TokenStream":
        return cls(vocab_size=vocab_size, seq_len=traffic["seq_len"],
                   global_batch=traffic["batch"], seed=seed,
                   noise=traffic["noise"], a=traffic["a"], b=traffic["b"])

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed % 2**64, step, 0x6B65]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Step `step`'s whole batch: int32 tokens and next-token targets,
        each (batch, seq_len)."""
        rng = self._rng(step)
        rows, s, v = self.global_batch, self.seq_len, self.vocab_size
        if rows > v:
            raise ValueError(f"{rows} rows cannot start from distinct tokens "
                             f"of a vocabulary of {v}")
        seq = np.empty((rows, s + 1), np.int64)
        seq[:, 0] = rng.permutation(v)[:rows]
        resets = rng.random((rows, s)) < self.noise
        drawn = rng.integers(0, v, (rows, s))
        for t in range(s):
            nxt = (seq[:, t] * self.a + self.b) % v
            seq[:, t + 1] = np.where(resets[:, t], drawn[:, t], nxt)
        seq = seq.astype(np.int32)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def host_slice(self, step: int, host_id: int, num_hosts: int
                   ) -> Dict[str, np.ndarray]:
        """Host `host_id`'s contiguous block of rows of step `step`."""
        if self.global_batch % num_hosts:
            raise ValueError(f"{self.global_batch} rows do not divide over "
                             f"{num_hosts} hosts")
        n = self.global_batch // num_hosts
        return {k: v[host_id * n:(host_id + 1) * n]
                for k, v in self.batch_at(step).items()}

    def state(self, step: int) -> Dict[str, int]:
        return {"step": int(step), "seed": int(self.seed)}

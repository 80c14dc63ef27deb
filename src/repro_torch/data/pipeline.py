"""Deterministic, shardable, resumable synthetic LM data pipeline: the
port's own copy of ``repro/data/pipeline.py`` (numpy only, so its batches
are bit-equal to the JAX package's).

Design rules for 1000-node training:
  * STATELESS addressing — `batch_at(step)` is a pure function of (seed, step),
    so exact restart needs only the integer step from the checkpoint, and any
    host can materialize exactly its slice (`host_slice`) without coordination.
  * The stream has learnable structure (noisy affine next-token process) so
    integration tests can assert that optimization actually reduces loss.
  * Domain decomposition of the batch axis reuses repro_torch.core.domain —
    the same scheme that shards the mesh (HDOT level-0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.domain import decompose_grid


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1          # fraction of uniformly random next-tokens
    # affine next-token process: x_{t+1} = (a*x_t + b) % V with prob 1-noise.
    # Default a=1 (shift cipher): learnable as one offset in embedding space,
    # so integration tests / examples show a fast visible loss drop; a=31
    # turns it into modular arithmetic (grokking-hard, measured ~flat at 200
    # steps on a 14M model).
    a: int = 1
    b: int = 7

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xD0D0]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Full global batch for `step` (tokens + next-token targets)."""
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        seq = np.empty((B, S + 1), np.int32)
        seq[:, 0] = rng.integers(0, V, B)
        noise_mask = rng.random((B, S)) < self.noise
        noise_tok = rng.integers(0, V, (B, S), dtype=np.int64)
        for t in range(S):
            nxt = (seq[:, t].astype(np.int64) * self.a + self.b) % V
            seq[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def host_slice(self, step: int, host_id: int, num_hosts: int
                   ) -> Dict[str, np.ndarray]:
        """This host's contiguous batch slice — same decompose_grid scheme the
        mesh uses for the batch axis."""
        boxes = decompose_grid((self.global_batch,), (num_hosts,))
        sl = boxes[host_id].slices()[0]
        full = self.batch_at(step)
        return {k: v[sl] for k, v in full.items()}

    # ------------------------------------------------------------------ state
    def state(self, step: int) -> Dict[str, int]:
        return {"step": int(step), "seed": int(self.seed)}

    @staticmethod
    def resume_step(state: Dict[str, int]) -> int:
        return int(state["step"])

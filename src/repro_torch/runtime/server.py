"""Batched serving runtime: prefill + iterative decode over slot-batched
caches, under two schedulers sharing one cache layout.

The port of ``repro/runtime/server.py``. ``run_wave`` is the static policy:
pad up to `slots` waiting prompts into one prefill, decode with a single
shared position until every slot finishes.

``run_continuous`` is true continuous batching: the moment a slot frees (EOS
or max_new_tokens) the next queued request is admitted into it — an
exact-width batch-1 prefill plus slot-level cache surgery (that slot's rows
of the live caches are overwritten), while the decode step stays one step
over all `slots` with a per-slot position vector. Because admission
prefills at the exact prompt width (no padding enters attention) and
replaces the slot's cache rows wholesale, every request's greedy outputs
equal those of serving it alone on a 1-slot server.

Greedy sampling is an argmax on the device; only the chosen ids cross to
the host, once a step. A non-greedy token is drawn on the device from a
``torch.Generator`` seeded by (seed, request id, tokens generated so far),
so a request's sampled stream does not depend on how arrivals interleave
(the draws differ from the JAX package's, whose generator is its own).

Empty cache slots: ``LanguageModel.prefill`` leaves the ring's ``pos`` tail
past the prompt at 0 (as the JAX package's ``cache_specs`` does), which
decode would read as "position 0, attended". Both schedulers mark it empty
(-1) with :func:`_mark_prefill_tail`. The JAX package does so only on
admission, so its ``run_wave`` attends to empty slots whenever ``max_len``
exceeds the prompt (``ROADMAP.md`` Queue 3); the port's wave does not.

Both schedulers admit by a token-only prefill, so they refuse the
encoder-decoder and VLM families (``NotImplementedError``), whose prefill
needs frames or patches per request: these are served through
``LanguageModel.prefill`` / ``decode_step`` with the frontend inputs in
the batch. The JAX package's ``run_continuous`` refuses them likewise; its
``run_wave`` fails on the missing input (``KeyError``, ``ROADMAP.md``
Queue 3).

Caches are updated in place, as everywhere in the port. Besides attention
rings they may hold recurrent state (Mamba-2's ``state`` and ``conv_*``,
RecurrentGemma's ``h`` and ``conv``): admission replaces a slot's rows of
every leaf, so a refilled slot starts from its new prompt's state. In the
wave scheduler the left-padding enters that state, so a short prompt's wave
output is not its solo output (as in the JAX package).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.model import LanguageModel

PyTree = Any


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    output: Optional[List[int]] = None
    # set by the server: submission id (also the non-greedy sampling stream
    # id, so outputs are independent of arrival interleaving) and the
    # monotonic completion timestamp
    rid: Optional[int] = None
    finish: Optional[float] = None


# ------------------------------------------------------- slot-cache surgery
def _walk(tree, fn, key=None):
    """Apply fn(key, leaf) to every tensor leaf of nested dicts/lists."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, key) for v in tree]
    return fn(key, tree)


def _walk2(dst, src, fn, key=None):
    """Apply fn(key, d, s) over two trees of the same structure."""
    if isinstance(dst, dict):
        for k in dst:
            _walk2(dst[k], src[k], fn, k)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _walk2(d, s, fn, key)
    else:
        fn(key, dst, src)


def make_slot_caches(model: LanguageModel, slots: int, max_len: int,
                     device="cuda") -> PyTree:
    """Decode caches for the continuous scheduler: the shared per-batch
    ``pos`` ring index (w,) becomes per-slot (slots, w), initialized to -1
    (= empty)."""
    caches = model.init_caches(slots, max_len, device)

    def fix(key, leaf):
        if key == "pos":
            return torch.full(leaf.shape[:-1] + (slots, leaf.shape[-1]), -1,
                              dtype=leaf.dtype, device=leaf.device)
        return leaf

    return _walk(caches, fix)


def _mark_prefill_tail(caches: PyTree, plen: int) -> PyTree:
    """A prompt shorter than the ring leaves the ``pos`` tail at its init
    value (0 = "position 0, attended"): mark everything past the prompt as
    empty, in place. No-op for prompts that filled or wrapped the ring (the
    s >= w prefill path already -1-fills)."""

    def fix(key, leaf):
        if key == "pos":
            leaf[..., plen:] = -1
        return leaf

    return _walk(caches, fix)


def _scatter_slot(dst: PyTree, src: PyTree, slot: int, slots: int) -> PyTree:
    """Write a batch-1 prefill cache into row `slot` of the server caches,
    in place. Per-slot ``pos`` leaves gain the slot axis at -2; every other
    leaf already carries the slot batch axis and is replaced row-wise. The
    slot axis is the first where the prefill leaf has 1 and the server leaf
    `slots`: the batch axis, after the layer axis of a stacked leaf and
    before an MQA ring's kv-head axis of 1."""

    def one(key, d, s):
        s = s.to(d.dtype)
        if d.dim() == s.dim() + 1:
            d.select(d.dim() - 2, slot).copy_(s)
            return
        ax = next(i for i, (ds_, ss_) in enumerate(zip(d.shape, s.shape))
                  if ss_ == 1 and ds_ == slots)
        d.narrow(ax, slot, 1).copy_(s)

    _walk2(dst, src, one)
    return dst


def _stream_seed(seed: int, rid: int, n: int) -> int:
    return int(np.random.SeedSequence([seed, rid, n]).generate_state(1)[0])


class BatchServer:
    """`decode_step_fn`, if given, replaces ``model.decode_step`` in
    ``run_continuous`` (``run_wave`` keeps the model's, as in the JAX
    package): the TP step of :func:`repro_torch.models.decode_tp.
    build_decode_step`. In a program of more than one rank such a step is
    collective: every rank runs this server over the same queue, admitting
    and prefilling alike, and calls the step together. The ranks must then
    choose the same token ids, or their schedulers part and the next ring
    waits forever, so every id the server chooses (admission and decode) is
    broadcast from global rank 0 whenever a `decode_step_fn` is given and
    the default process group has more than one rank. Rounding is not left
    to decide it: the admission prefills run on separate cards, and the
    step's logits, though computed from the same gathered rows on every
    rank, come out of GEMMs the ranks launch separately. ``stats
    ["ids_off_rank0"]`` counts the ids of live rows that this rank had
    chosen otherwise before the broadcast. A server on each rank of its own
    (its own queue, or no collective step) takes no `decode_step_fn`."""

    def __init__(self, model: LanguageModel, params, slots: int = 8,
                 max_len: int = 1024, greedy: bool = True, seed: int = 0,
                 decode_step_fn: Optional[Callable] = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.seed = seed
        self.queue: List[Request] = []
        self.stats = {"decode_steps": 0, "prefills": 0, "waves": 0,
                      "admitted": 0, "ids_off_rank0": 0}
        self._next_rid = 0
        self._cont = None
        self._decode_step_fn = decode_step_fn
        self._agree = (decode_step_fn is not None and dist.is_available()
                       and dist.is_initialized()
                       and dist.get_world_size() > 1)

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("empty prompt: nothing to prefill")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)} tokens) + max_new_tokens "
                f"({req.max_new_tokens}) = {need} exceeds the server's "
                f"cache capacity max_len={self.max_len}; generated tokens "
                f"would evict the prompt from the ring cache")
        if req.rid is None:
            req.rid = self._next_rid
            self._next_rid += 1
        self.queue.append(req)

    def _refuse_frontend_families(self) -> None:
        if self.model.cfg.family in ("vlm", "encdec"):
            raise NotImplementedError(
                "the server admits via token-only prefill; family "
                f"{self.model.cfg.family!r} needs frontend inputs per "
                "request (serve it through model.prefill / decode_step)")

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _prefill(self, toks: np.ndarray):
        logits, caches = self.model.prefill(
            self.params, {"tokens": self._tensor(toks)}, max_len=self.max_len)
        self.stats["prefills"] += 1
        # disagreement with the JAX package's wave: mark empty slots -1
        return logits, _mark_prefill_tail(caches, toks.shape[1])

    def _pad_prompts(self, reqs: List[Request]) -> np.ndarray:
        width = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), width), np.int64)
        for i, r in enumerate(reqs):
            toks[i, width - len(r.prompt):] = r.prompt  # left-pad
        return toks

    # ----------------------------------------------------------- sampling
    def _choose(self, logits: torch.Tensor, reqs) -> List[int]:
        """One token id per row of (b, 1, vocab) logits; rows whose request
        is None are idle (greedy only: they cost nothing extra)."""
        rows = logits[:, -1, :]
        if self.greedy:
            ids = rows.argmax(dim=-1)
        else:
            ids = torch.stack([
                self._sample_row(rows[i], r) if r is not None
                else torch.zeros((), dtype=torch.int64, device=rows.device)
                for i, r in enumerate(reqs)])
        if not self._agree:
            return ids.tolist()
        mine = ids.clone()
        dist.broadcast(ids, src=0)
        mine, ids = torch.stack([mine, ids]).tolist()
        self.stats["ids_off_rank0"] += sum(
            a != b for a, b, r in zip(mine, ids, reqs) if r is not None)
        return ids

    def _sample_row(self, row: torch.Tensor, req: Request) -> torch.Tensor:
        """A categorical draw from one row of logits (Gumbel-max), keyed by
        (seed, request id, tokens generated so far)."""
        n = 0 if req.output is None else len(req.output)
        gen = torch.Generator(device=row.device).manual_seed(
            _stream_seed(self.seed, req.rid, n))
        u = torch.rand(row.shape, generator=gen, dtype=torch.float32,
                       device=row.device)
        return torch.argmax(row.float() - torch.log(-torch.log(u)))

    # ------------------------------------------------------- wave scheduler
    def run_wave(self) -> List[Request]:
        """Serve up to `slots` queued requests to completion."""
        self._refuse_frontend_families()
        if not self.queue:
            return []
        reqs, self.queue = self.queue[:self.slots], self.queue[self.slots:]
        for r in reqs:
            r.output = []
        toks = self._pad_prompts(reqs)
        b, plen = toks.shape
        logits, caches = self._prefill(toks)
        self.stats["waves"] += 1
        max_new = max(r.max_new_tokens for r in reqs)
        done = np.zeros(b, bool)
        pos = plen
        for _ in range(max_new):
            ids = self._choose(logits, [None if done[i] else r
                                        for i, r in enumerate(reqs)])
            for i, r in enumerate(reqs):
                if not done[i]:
                    r.output.append(ids[i])
                    if self._finished(r, ids[i]):
                        done[i] = True
                        r.finish = time.monotonic()
            if done.all():
                break
            token = self._tensor(ids)[:, None]
            logits, caches = self.model.decode_step(self.params, token,
                                                    caches, pos)
            self.stats["decode_steps"] += 1
            pos += 1
        return reqs

    def run_all(self) -> List[Request]:
        served: List[Request] = []
        while self.queue:
            served.extend(self.run_wave())
        return served

    # ------------------------------------------------- continuous scheduler
    def run_continuous(self, poll: Optional[Callable[[], bool]] = None
                       ) -> List[Request]:
        """Token-granular continuous batching: serve the queue to completion,
        admitting a queued request into a slot the same step it frees.

        `poll`, if given, is called once per scheduler iteration; it may
        submit new requests and returns True while more arrivals may still
        come — the loop then idles instead of returning when the queue
        drains.
        """
        self._refuse_frontend_families()
        st = self._continuous_state()
        served: List[Request] = []
        while True:
            more = bool(poll()) if poll is not None else False
            # token-granular admission: fill every free slot from the queue
            for s in range(self.slots):
                if st["req"][s] is not None:
                    continue
                while self.queue:
                    req = self.queue.pop(0)
                    req.output = []
                    tok = self._admit(req, s)
                    req.output.append(tok)
                    if self._finished(req, tok):
                        # EOS or max_new_tokens=1 on the first sampled token:
                        # the slot is still free — admit the next request now
                        req.finish = time.monotonic()
                        served.append(req)
                        continue
                    st["req"][s] = req
                    st["tok"][s] = tok
                    st["pos"][s] = len(req.prompt)
                    break
            active = [i for i in range(self.slots) if st["req"][i] is not None]
            if not active:
                if self.queue:
                    continue
                if more:
                    time.sleep(5e-4)
                    continue
                break
            # one decode step over ALL slots; idle rows carry stale token/pos
            # and only ever write their own cache rows, which admission
            # replaces wholesale
            decode = self._decode_step_fn or self.model.decode_step
            logits, st["caches"] = decode(
                self.params, self._tensor(st["tok"])[:, None], st["caches"],
                self._tensor(st["pos"]))
            self.stats["decode_steps"] += 1
            st["pos"] += 1
            ids = self._choose(logits, st["req"])
            for i in active:
                r = st["req"][i]
                r.output.append(ids[i])
                st["tok"][i] = ids[i]
                if self._finished(r, ids[i]):
                    r.finish = time.monotonic()
                    served.append(r)
                    st["req"][i] = None  # freed: next iteration admits here
        return served

    def _finished(self, req: Request, tok: int) -> bool:
        return ((req.eos_id is not None and tok == req.eos_id)
                or len(req.output) >= req.max_new_tokens)

    def _continuous_state(self):
        if self._cont is None:
            self._cont = {
                "caches": make_slot_caches(self.model, self.slots,
                                           self.max_len, self.device),
                "req": [None] * self.slots,
                "tok": np.zeros(self.slots, np.int64),
                "pos": np.zeros(self.slots, np.int64),
            }
        return self._cont

    def _admit(self, req: Request, slot: int) -> int:
        """Prefill `req` at its exact prompt width (batch 1, no padding — the
        outputs equal a solo server's) and write its cache into the freed
        slot's rows; returns the first sampled token."""
        logits, pc = self._prefill(np.asarray([req.prompt], np.int64))
        _scatter_slot(self._cont["caches"], pc, slot, self.slots)
        self.stats["admitted"] += 1
        return self._choose(logits, [req])[0]

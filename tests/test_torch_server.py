"""The port's BatchServer on the CPU: the properties of the JAX package's
``tests/test_server.py``, the port's greedy outputs against JAX's on the
same parameters (reduced qwen3-8b, 2 layers, float32; the recurrent and
MoE families, each scheduler against the JAX package's same scheduler),
and the wave scheduler's empty cache slots, where the port and the JAX
package disagree.

The load-bearing property: admission prefills at the exact prompt width
(batch 1, no padding) and replaces the freed slot's cache rows wholesale,
so each request's greedy output equals serving it alone on a 1-slot server,
for any interleaving of arrivals.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import both_models, f32, jitted

from repro.runtime.server import BatchServer as JaxServer
from repro.runtime.server import Request as JaxRequest
from repro_torch.runtime.server import (
    BatchServer,
    Request,
    _mark_prefill_tail,
    _scatter_slot,
    _walk,
    make_slot_caches,
)

PROMPTS = [[5, 9, 3], [7, 1], [2, 2, 2, 2, 8], [11], [4, 6]]
MAX_NEW = [4, 6, 2, 1, 5]


@pytest.fixture(scope="module")
def models():
    return both_models("qwen3-8b", "f32", num_layers=2)


@pytest.fixture(scope="module")
def solo_outputs(models):
    """Each request served alone on a 1-slot continuous server: the oracle
    every interleaving must reproduce."""
    _, _, model, params = models
    outs = []
    for p, m in zip(PROMPTS, MAX_NEW):
        srv = BatchServer(model, params, slots=1, max_len=16)
        srv.submit(Request(prompt=list(p), max_new_tokens=m))
        [r] = srv.run_continuous()
        outs.append(r.output)
    return outs


def _server(models, **kw):
    kw.setdefault("max_len", 16)
    return BatchServer(models[2], models[3], **kw)


def test_continuous_matches_solo_for_any_interleaving(models, solo_outputs):
    """Arrivals submitted up-front, reversed, and staggered mid-decode via
    the poll hook: per-request outputs equal the 1-slot server's."""

    def run(slots, order, stagger):
        srv = _server(models, slots=slots)
        pending = [Request(prompt=list(PROMPTS[j]), max_new_tokens=MAX_NEW[j],
                           rid=j) for j in order]
        if stagger is None:
            for r in pending:
                srv.submit(r)
            served = srv.run_continuous()
        else:
            it = {"n": -1}

            def poll():
                it["n"] += 1
                for r, at in zip(pending, stagger):
                    if at == it["n"]:
                        srv.submit(r)
                return any(at > it["n"] for at in stagger)

            served = srv.run_continuous(poll)
        assert len(served) == len(PROMPTS)
        return {r.rid: r.output for r in served}

    for got in (run(2, range(len(PROMPTS)), None),
                run(3, reversed(range(len(PROMPTS))), None),
                run(2, range(len(PROMPTS)), [0, 0, 2, 3, 5])):
        for j, exp in enumerate(solo_outputs):
            assert got[j] == exp


def test_greedy_outputs_match_jax(models, solo_outputs):
    """The JAX package's continuous server on the same parameters gives the
    same tokens as the port's."""
    jm, jp, _, _ = models
    srv = JaxServer(jm, jp, slots=2, max_len=16)
    for j, (p, m) in enumerate(zip(PROMPTS, MAX_NEW)):
        srv.submit(JaxRequest(prompt=list(p), max_new_tokens=m, rid=j))
    got = {r.rid: r.output for r in srv.run_continuous()}
    assert [got[j] for j in range(len(PROMPTS))] == solo_outputs


def test_eos_on_first_decoded_token(models, solo_outputs):
    srv = _server(models, slots=1)
    for p, out in zip(PROMPTS[:3], solo_outputs[:3]):
        srv.submit(Request(prompt=list(p), max_new_tokens=8, eos_id=out[0]))
    served = srv.run_continuous()
    assert [r.output for r in served] == [[o[0]] for o in solo_outputs[:3]]
    assert srv.stats["decode_steps"] == 0
    assert srv.stats["admitted"] == 3


def test_all_slots_finish_same_step(models):
    srv = _server(models, slots=2)
    for _ in range(2):
        srv.submit(Request(prompt=[5, 9, 3], max_new_tokens=4))
    served = srv.run_continuous()
    assert len(served) == 2
    assert served[0].output == served[1].output      # identical requests
    # lockstep: one admission token + (max_new - 1) shared decode steps
    assert srv.stats["decode_steps"] == 3


def test_queue_longer_than_slots_across_refills(models):
    srv = _server(models, slots=2)
    want = []
    for i in range(7):
        m = 1 + (i % 3)
        want.append(m)
        srv.submit(Request(prompt=[3 + i], max_new_tokens=m))
    served = srv.run_continuous()
    assert len(served) == 7
    assert sorted(len(r.output) for r in served) == sorted(want)
    assert srv.stats["admitted"] == 7 == srv.stats["prefills"]


def test_max_new_tokens_one(models):
    srv = _server(models, slots=2)
    srv.submit(Request(prompt=[5, 9, 3], max_new_tokens=1))
    [r] = srv.run_continuous()
    assert len(r.output) == 1
    assert srv.stats["decode_steps"] == 0


def test_nongreedy_sampling_deterministic_under_fixed_seed(models):
    """Non-greedy draws are keyed by (seed, request id, #generated), so a
    fixed seed pins the sampled streams whatever the slot count, and the
    wave scheduler draws the same streams."""

    def run(slots, seed, wave=False):
        srv = _server(models, slots=slots, greedy=False, seed=seed)
        for p in PROMPTS[:3]:
            srv.submit(Request(prompt=list(p), max_new_tokens=5))
        served = srv.run_all() if wave else srv.run_continuous()
        return {r.rid: r.output for r in served}

    assert run(1, seed=7) == run(3, seed=7) == run(1, seed=7, wave=True)
    assert run(3, seed=7) != run(3, seed=8)


def test_wave_scheduler_serves(models):
    srv = _server(models, slots=2)
    for p, m in zip(PROMPTS, MAX_NEW):
        srv.submit(Request(prompt=list(p), max_new_tokens=m))
    served = srv.run_all()
    assert [len(r.output) for r in served] == MAX_NEW
    assert srv.stats["waves"] == 3                   # ceil(5 / 2)


def test_submit_rejects_what_the_cache_cannot_hold(models):
    srv = _server(models, slots=1, max_len=8)
    for bad in (Request(prompt=[], max_new_tokens=2),
                Request(prompt=[1, 2], max_new_tokens=0),
                Request(prompt=[1] * 6, max_new_tokens=3)):
        with pytest.raises(ValueError):
            srv.submit(bad)
    with pytest.raises(ValueError):
        BatchServer(models[2], models[3], slots=0)


def test_scatter_slot_touches_only_its_rows(models):
    """Admission surgery writes exactly the freed slot's rows: every other
    slot's k/v/pos rows are unchanged (the port writes in place, so the
    'before' state is a copy)."""
    _, _, model, params = models
    slots, max_len, slot = 3, 16, 1
    live = make_slot_caches(model, slots, max_len, "cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in (live["k"], live["v"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = {k: v.clone() for k, v in live.items()}
    _, pc = model.prefill(params, {"tokens": torch.tensor([[5, 9, 3]])},
                          max_len=max_len)
    pc = _mark_prefill_tail(pc, 3)
    after = _scatter_slot(live, pc, slot, slots)
    assert after is live
    for key in ("k", "v", "pos"):          # slot axis: 1 in every leaf here
        for other in (0, 2):
            assert torch.equal(after[key][:, other], before[key][:, other])
        want = pc[key][:, 0] if key != "pos" else pc[key]
        assert torch.equal(after[key][:, slot], want.to(after[key].dtype))
    assert after["pos"][:, slot, :3].tolist() == [[0, 1, 2]] * 2
    assert bool((after["pos"][:, slot, 3:] == -1).all())


def test_slot_caches_pos_initialized_empty(models):
    caches = make_slot_caches(models[2], 4, 16, "cpu")
    assert caches["pos"].shape == (2, 4, 16)        # (layers, slots, w)
    assert bool((caches["pos"] == -1).all())
    assert caches["k"].shape[:3] == (2, 4, 16)


def test_wave_marks_empty_cache_slots(models):
    """The JAX package's wave prefills into a ring longer than the prompt
    and leaves the tail's ``pos`` at 0, so decode attends to empty slots
    (ROADMAP.md Queue 3): at max_len 64 its outputs and first decode logits
    are off a full forward. The port marks the tail empty and equals it."""
    jm, jp, model, params = models
    prompt = [217, 163, 131, 69, 79, 11]

    def full_forward_greedy(n):
        out = []
        for _ in range(n):
            logits, _ = model.prefill(params,
                                      {"tokens": torch.tensor([prompt + out])})
            out.append(int(logits[0, -1].argmax()))
        return out

    want = full_forward_greedy(4)
    jsrv = JaxServer(jm, jp, slots=1, max_len=64)
    jsrv.submit(JaxRequest(prompt=list(prompt), max_new_tokens=4))
    assert jsrv.run_all()[0].output != want
    for max_len in (64, 10):
        srv = BatchServer(model, params, slots=1, max_len=max_len)
        srv.submit(Request(prompt=list(prompt), max_new_tokens=4))
        assert srv.run_all()[0].output == want
    # the first decode step's logits, both packages, against a full forward
    full, _ = model.prefill(params,
                            {"tokens": torch.tensor([prompt + want[:1]])})
    prefill, decode = jitted(jm)
    _, jc = prefill(jp, {"tokens": np.asarray([prompt], np.int32)},
                    max_len=64)
    jl, _ = decode(jp, np.asarray([want[:1]], np.int32), jc,
                   np.asarray(len(prompt), np.int32))
    assert np.abs(f32(jl)[0, -1] - f32(full)[0, -1]).max() > 0.5
    _, tc = model.prefill(params, {"tokens": torch.tensor([prompt])},
                          max_len=64)
    tl, _ = model.decode_step(params, torch.tensor([want[:1]]),
                              _mark_prefill_tail(tc, len(prompt)),
                              len(prompt))
    np.testing.assert_allclose(f32(tl)[0, -1], f32(full)[0, -1], rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------ recurrent families
# Mamba-2 (scanned: every leaf stacked over the layers) and RecurrentGemma
# (rglru, rglru, local_attn: a 32-slot MQA ring and recurrent state), both
# reduced, float32. Their caches hold recurrent state besides rings: the
# slot surgery must carry it, and a refilled slot must start from the new
# prompt's state, not the old request's.
REC = {"mamba2-780m": dict(num_layers=2),
       "recurrentgemma-2b": dict(num_layers=3)}
REC_PROMPTS = [[5, 9, 3, 7], [7, 1], [2, 2, 2, 2, 8], [11], [4, 6, 1, 9, 2]]
REC_MAX_NEW = [4, 6, 2, 3, 5]


@pytest.fixture(scope="module", params=sorted(REC))
def rec(request):
    arch = request.param
    jm, jp, model, params = both_models(arch, "f32", **REC[arch])
    solo = []
    for p, m in zip(REC_PROMPTS, REC_MAX_NEW):
        srv = BatchServer(model, params, slots=1, max_len=48)
        srv.submit(Request(prompt=list(p), max_new_tokens=m))
        [r] = srv.run_continuous()
        solo.append(r.output)
    return {"arch": arch, "jax": (jm, jp), "model": model, "params": params,
            "solo": solo}


def test_recurrent_continuous_matches_solo(rec):
    """Any interleaving (2 slots, 3 slots reversed, staggered arrivals)
    gives each request its solo output, 1- and 2-token prompts included:
    five requests through two slots refill slots whose recurrent state
    belonged to a finished request."""

    def run(slots, order, stagger=None):
        srv = BatchServer(rec["model"], rec["params"], slots=slots,
                          max_len=48)
        pending = [Request(prompt=list(REC_PROMPTS[j]),
                           max_new_tokens=REC_MAX_NEW[j], rid=j)
                   for j in order]
        if stagger is None:
            for r in pending:
                srv.submit(r)
            return {r.rid: r.output for r in srv.run_continuous()}
        it = {"n": -1}

        def poll():
            it["n"] += 1
            for r, at in zip(pending, stagger):
                if at == it["n"]:
                    srv.submit(r)
            return any(at > it["n"] for at in stagger)

        return {r.rid: r.output for r in srv.run_continuous(poll)}

    n = len(REC_PROMPTS)
    for got in (run(2, range(n)), run(3, reversed(range(n))),
                run(2, range(n), [0, 0, 2, 3, 5])):
        assert [got[j] for j in range(n)] == rec["solo"]


def test_recurrent_greedy_outputs_match_jax(rec):
    """The JAX package's continuous server gives the port's tokens. Prompts
    of at least conv_kernel - 1 = 3 tokens: on shorter ones the JAX package
    keeps a short conv state and fails (ROADMAP.md Queue 3)."""
    jm, jp = rec["jax"]
    keep = [j for j, p in enumerate(REC_PROMPTS) if len(p) >= 3]
    srv = JaxServer(jm, jp, slots=2, max_len=48)
    for j in keep:
        srv.submit(JaxRequest(prompt=list(REC_PROMPTS[j]),
                              max_new_tokens=REC_MAX_NEW[j], rid=j))
    got = {r.rid: r.output for r in srv.run_continuous()}
    assert [got[j] for j in keep] == [rec["solo"][j] for j in keep]


def test_recurrent_wave_matches_jax_wave(rec):
    """The wave scheduler left-pads prompts, and in a recurrent layer the
    pad tokens enter the state: wave output is not solo output, in either
    package, and the port's equals JAX's. The prompts are long enough
    (padded to 34 tokens) that JAX's wave fills RecurrentGemma's 32-slot
    ring, so its empty-slot fault (ROADMAP.md Queue 3) does not enter."""
    jm, jp = rec["jax"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, n).tolist() for n in (34, 20, 31, 3)]
    outs = []
    for srv_cls, req_cls, m, p in ((BatchServer, Request, rec["model"],
                                    rec["params"]),
                                   (JaxServer, JaxRequest, jm, jp)):
        srv = srv_cls(m, p, slots=2, max_len=48)
        for pr in prompts:
            srv.submit(req_cls(prompt=list(pr), max_new_tokens=5))
        outs.append([r.output for r in srv.run_all()])
    assert outs[0] == outs[1]
    # the pad tokens moved the state: padded logits are not the solo ones
    model, params = rec["model"], rec["params"]
    padded, _ = model.prefill(params, {"tokens": torch.tensor(
        [[0] * 14 + prompts[1]])})
    alone, _ = model.prefill(params, {"tokens": torch.tensor([prompts[1]])})
    assert float((padded - alone).abs().max()) > 1e-3


def test_recurrent_scatter_slot_carries_the_state(rec):
    """Admission surgery on caches with recurrent leaves: the slot axis is
    found in every leaf (stacked Mamba-2 state and conv inputs; the MQA
    ring's kv-head axis of size 1 is not taken for it), the freed slot's
    rows become the prefill's exactly, and the other slots' rows do not
    change."""
    model, params = rec["model"], rec["params"]
    slots, slot = 3, 1
    live = make_slot_caches(model, slots, 48, "cpu")
    gen = torch.Generator().manual_seed(0)
    leaves = []

    def fill(key, leaf):
        if key != "pos":
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        leaves.append((key, leaf))
        return leaf

    _walk(live, fill)
    before = [(k, v.clone()) for k, v in leaves]
    _, pc = model.prefill(params, {"tokens": torch.tensor([[5, 9, 3, 7]])},
                          max_len=48)
    pc = _mark_prefill_tail(pc, 4)
    src = []
    _walk(pc, lambda k, v: src.append(v) or v)
    _scatter_slot(live, pc, slot, slots)
    stacked = not isinstance(live, list)        # Mamba-2: (layers, slots, ...)
    seen = set()
    for (key, now), (_, old), s in zip(leaves, before, src):
        seen.add(key)
        ax = 1 if stacked else 0
        if key == "pos":                          # per-slot ring index
            ax = now.dim() - 2
            s = s.unsqueeze(ax)
        for other in (0, 2):
            assert torch.equal(now.select(ax, other), old.select(ax, other))
        assert torch.equal(now.narrow(ax, slot, 1), s.to(now.dtype))
    want = ({"state", "conv_x", "conv_B", "conv_C"} if stacked
            else {"h", "conv", "k", "v", "pos"})
    assert seen == want


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b",
                                  "mamba2-780m", "recurrentgemma-2b"])
def test_serve_launcher_serves_every_ported_family(arch, scheduler, capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", arch, "--device", "cpu", "--requests", "3",
                 "--slots", "2", "--max-new", "3", "--scheduler",
                 scheduler]) == 0
    out = capsys.readouterr().out
    assert out.count("-> 3 tokens") == 3
    assert "served 3 requests" in out


# ------------------------------------------------------------ MoE family
# Reduced Qwen3-MoE and Mixtral (4 experts, top-2, capacity factor 1.25),
# 2 layers, float32, unrolled draws (ROADMAP.md Queue 3: the scanned draw's
# large weights amplify rounding in Mixtral, which has no qk-norm). In a
# prefill every sequence is a group with its own capacity, so in the wave
# scheduler a prompt's left-padding routes through the experts and takes
# capacity: its output depends on its neighbours' lengths, in both
# packages, and wave output is never held against continuous output.
MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-30b-a3b")
MOE_PROMPT_LENS = (70, 9, 66, 3)        # Mixtral's reduced window is 64
MOE_MAX_NEW = [4, 6, 3, 5]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_models(request):
    jm, jp, model, params = both_models(request.param, "f32", scan=False,
                                        num_layers=2)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 256, n).tolist() for n in MOE_PROMPT_LENS]
    return {"arch": request.param, "jax": (jm, jp), "model": model,
            "params": params, "prompts": prompts}


def _jax_wave_marked(jm, jp, prompts, max_new, max_len):
    """The JAX package's wave schedule, step by step through its jitted
    prefill and decode_step, with the prefill's empty ring slots marked
    -1 (the repair its run_wave lacks, ROADMAP.md Queue 3): left-padded
    prompts, one prefill, greedy decode at one shared position."""
    prefill, decode = jitted(jm)
    width = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        toks[i, width - len(p):] = p
    logits, caches = prefill(jp, {"tokens": toks}, max_len=max_len)
    caches = jax.tree_util.tree_map_with_path(
        lambda path, a: a.at[..., width:].set(-1)
        if getattr(path[-1], "key", None) == "pos" else a, caches)
    outs = [[] for _ in prompts]
    for n in range(max(max_new)):
        ids = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        for i, m in enumerate(max_new):
            if n < m:
                outs[i].append(int(ids[i]))
        logits, caches = decode(jp, jnp.asarray(ids[:, None], jnp.int32),
                                caches, jnp.asarray(width + n, jnp.int32))
    return outs


def test_moe_continuous_matches_jax_continuous(moe_models):
    """The port's continuous scheduler (3 slots, 4 requests: a slot is
    refilled) gives the JAX package's continuous scheduler's tokens, and
    each request's solo tokens: at decode every sequence is its own group
    with capacity k, so nothing is ever dropped there and the slots do not
    interact."""
    jm, jp = moe_models["jax"]
    prompts = moe_models["prompts"]
    outs = []
    for cls, req, m, p in ((BatchServer, Request, moe_models["model"],
                            moe_models["params"]),
                           (JaxServer, JaxRequest, jm, jp)):
        srv = cls(m, p, slots=3, max_len=80)
        for j, (pr, n) in enumerate(zip(prompts, MOE_MAX_NEW)):
            srv.submit(req(prompt=list(pr), max_new_tokens=n, rid=j))
        got = {r.rid: r.output for r in srv.run_continuous()}
        outs.append([got[j] for j in range(len(prompts))])
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == MOE_MAX_NEW
    for j in (1, 3):
        srv = BatchServer(moe_models["model"], moe_models["params"], slots=1,
                          max_len=80)
        srv.submit(Request(prompt=list(prompts[j]),
                           max_new_tokens=MOE_MAX_NEW[j]))
        assert srv.run_continuous()[0].output == outs[0][j]


def test_moe_wave_matches_jax_wave(moe_models):
    """The port's wave scheduler (2 slots: two waves of 2) against the
    JAX package's wave schedule with its empty ring slots marked, wave by
    wave; for Mixtral, whose prompts here are padded past its 64-slot
    ring, the JAX package's own run_wave has no empty slot and is held
    too. The left-padding moved the MoE's routing: a short prompt's wave
    output is not what it gets alone."""
    jm, jp = moe_models["jax"]
    model, params = moe_models["model"], moe_models["params"]
    prompts = moe_models["prompts"]
    srv = BatchServer(model, params, slots=2, max_len=80)
    for pr, n in zip(prompts, MOE_MAX_NEW):
        srv.submit(Request(prompt=list(pr), max_new_tokens=n))
    got = [r.output for r in srv.run_all()]
    want = []
    for w in (0, 2):
        want += _jax_wave_marked(jm, jp, prompts[w:w + 2],
                                 MOE_MAX_NEW[w:w + 2], 80)
    assert got == want
    if moe_models["arch"] == "mixtral-8x7b":
        jsrv = JaxServer(jm, jp, slots=2, max_len=80)
        for pr, n in zip(prompts, MOE_MAX_NEW):
            jsrv.submit(JaxRequest(prompt=list(pr), max_new_tokens=n))
        assert [r.output for r in jsrv.run_all()] == got
    padded, _ = model.prefill(params, {"tokens": torch.tensor(
        [[0] * 61 + prompts[1]])})
    alone, _ = model.prefill(params, {"tokens": torch.tensor([prompts[1]])})
    assert float((padded - alone).abs().max()) > 1e-3

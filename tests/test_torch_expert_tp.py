"""Expert TP: MoE models whose experts do not divide the "model" axis,
trained and served tensor-parallel, against the JAX package.

The rules then replicate the experts and split their ``d_ff_expert``
columns over "model" (``repro/sharding/rules.py``), and the JAX model runs
``moe_apply_dense`` under GSPMD ("mixtral's 8 experts on a 16-wide model
axis -> expert-TP", ``repro/models/moe.py``). The port's
``moe.moe_apply_expert_tp`` gathers the rank's rows, routes the whole
sequence at the reference's capacity, runs the rank's columns and
reduce-scatters the combined partial sums back to the rows.

Reduced Mixtral-8x7B (top 2, capacity factor 1.25, so tokens are dropped
exactly where the reference drops them) with 6 experts on gloo ("data",
"model") (1, 4), and 3 experts on (2, 2) and ("pod", "data", "model")
(2, 1, 2), float32, parameters drawn unrolled with numpy and loaded
through ``params_from_jax``:

(a) the TP trainer, 3 steps: losses, grad norms and parameters match the
JAX Trainer without a mesh at rtol 1e-4; every rank reports the same;
each rank holds every expert and its block of the columns.
(b) the prefill and decode cells (``build_cell``, ``cell_step``): 2
prompts of 12 tokens, then 8 teacher-forced decode steps; the gathered
logits match JAX ``model.prefill`` / ``decode_step`` on one device at
rtol 1e-4.
(c) the collectives of an expert-TP layer, from the cut's log: one
all-gather and one reduce-scatter a layer, forward, in training and in
the prefill; no MoE all-to-all anywhere.
(d) Whisper with 62 frames on (1, 4), which do not divide over the 4
ranks (Whisper-base's 1500 do not over the production mesh's 16): the
encoder's rows padded at the end and the pad dropped after the gather
(the encoder is causal), trained and served against the JAX package as
in (a) and (b).

One spawn a mesh (``tests/_torch_dist.py``) runs both jobs, with one
deadline.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_dist import (case_cfg, flat, params_close_tiny_v, spawn,
                         tp_init_key, tp_run)
from _torch_jax import numpy_params
from _torch_serve import T
from _torch_serve import case_cfg as serve_case_cfg
from test_torch_serve_cells import _jax_logits

from repro.config.base import ParallelConfig as JaxParallel
from repro.config.base import RunConfig as JaxRun
from repro.config.base import TrainConfig as JaxTrain
from repro.config.registry import get_arch as jax_arch
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.optim import adamw_init as jadamw_init
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config.registry import get_arch
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import leaf_paths, tree_leaves
from repro_torch.optim import adamw_init

SPAWN_DEADLINE_S = 180
SPEC = dict(steps=3, global_batch=8, seq_len=16, lr=5e-3, total_steps=6)
A = "mixtral-8x7b"
LAYERS = 4          # the reduced config's


def _case(tag, experts, remat="none", accum=1):
    return dict(tag=tag, arch=A, accum=accum, scan=False, remat=remat,
                experts=experts, log=True, moments=True)


MESHES = {
    "1x4": dict(mesh=[1, 4], axes=["data", "model"],
                case=_case("e6", 6)),
    "2x2": dict(mesh=[2, 2], axes=["data", "model"],
                case=_case("e3", 3, "full")),
    "2x1x2": dict(mesh=[2, 1, 2], axes=["pod", "data", "model"],
                  case=_case("e3", 3, accum=2)),
}
# (d): frames that do not divide over the (1, 4) ranks
WHISPER = dict(tag="w62", arch="whisper-base", accum=1, scan=False,
               remat="none", enc_seq=62, moments=True)


def _serve_case(case):
    if case["arch"] != A:
        return dict(tag=case["tag"] + "s", arch=case["arch"],
                    enc_seq=case["enc_seq"])
    return dict(tag=f"s{case['experts']}", arch=A, experts=case["experts"])


def _cases(name):
    return [MESHES[name]["case"]] + ([WHISPER] if name == "1x4" else [])


def _numpy_tree(case):
    jcfg = case_cfg(jax_arch(case["arch"]).reduced(), case)
    return numpy_params(jax_build(jcfg, JaxOptions(dtype=jnp.float32,
                                                   scan_layers=False)))


def _port_params(tree, case):
    run, opts = tp_run(SPEC, case, "unused")
    return params_from_jax(tree, run.model, opts, "cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: per-rank results} of one spawn a mesh running the case's TP
    training (``tp_train``) and its serving cells (``serve_cells``)."""
    cache = {}

    def get(name):
        if name not in cache:
            workdir = tmp_path_factory.mktemp(f"etp{name}")
            m = MESHES[name]
            for case in _cases(name):
                tree = _numpy_tree(case)
                p = _port_params(tree, case)
                save_checkpoint(str(workdir / f"init_{tp_init_key(case)}"),
                                0, {"params": p, "opt": adamw_init(p)},
                                extra={"data_step": 0})
                np.savez(workdir / f"{_serve_case(case)['tag']}.npz",
                         **{f"leaf{i}": np.asarray(x, np.float32)
                            for i, x in enumerate(jax.tree.leaves(tree))})
            job = dict(mesh=m["mesh"],
                       tp_train=dict(SPEC, mesh=m["mesh"], axes=m["axes"],
                                     cases=_cases(name)),
                       serve_cells=dict(mesh=m["mesh"], axes=m["axes"],
                                        cases=[_serve_case(c)
                                               for c in _cases(name)]))
            cache[name] = spawn(job, None, workdir, SPAWN_DEADLINE_S)
        return cache[name]
    return get


def _jax_train(case):
    """The JAX Trainer without a mesh (unrolled, float32) from the case's
    numpy parameters: (metrics, final parameters, AdamW second moments)."""
    jcfg = case_cfg(jax_arch(case["arch"]).reduced(), case)
    jt = JaxTrainer(
        JaxRun(model=jcfg,
               parallel=JaxParallel(accum_steps=case["accum"],
                                    remat=case["remat"], scan_layers=False),
               train=JaxTrain(warmup_steps=2, total_steps=SPEC["total_steps"],
                              checkpoint_every=10 ** 6, seed=3,
                              global_batch=SPEC["global_batch"],
                              seq_len=SPEC["seq_len"], lr=SPEC["lr"])),
        options=JaxOptions(dtype=jnp.float32, scan_layers=False,
                           remat=case["remat"]))
    jt.init_state()
    jt.params = jax.tree.map(jnp.asarray, _numpy_tree(case))
    jt.opt_state = jadamw_init(jt.params)
    jt.train(SPEC["steps"])
    return ({k: [m[k] for m in jt.metrics_log]
             for k in ("loss", "grad_norm", "lr")},
            jax.tree.map(np.asarray, jt.params),
            jax.tree.map(np.asarray, jt.opt_state["v"]))


@pytest.mark.parametrize("name", list(MESHES))
def test_expert_tp_trainer_matches_jax(runs, name):
    """3 steps of the TP trainer with the experts replicated and their
    columns over "model": every rank reports the same losses, grad norms
    and full parameters, and they match the JAX Trainer without a mesh at
    rtol 1e-4 (parameters by the tiny-second-moment rule of
    ``params_close_tiny_v``). Each rank holds every expert, its block of
    the ``d_ff_expert`` columns (gate, up) and rows (down)."""
    ranks = runs(name)
    case = MESHES[name]["case"]
    tag = case["tag"]
    final = _trainer_matches_jax(ranks, case)
    tp = MESHES[name]["mesh"][-1]
    f = get_arch(A).reduced().moe.d_ff_expert
    for out in ranks:
        index = json.loads(str(out[f"{tag}_index"]))
        for path, ix in zip(leaf_paths(final), index):
            if path[-2:-1] == ("moe",) and path[-1] != "router":
                assert ix[0] == [0, case["experts"]]
                cols = ix[1] if path[-1] == "down" else ix[2]
                assert cols[1] - cols[0] == f // tp


@pytest.mark.parametrize("name", list(MESHES))
def test_expert_tp_cells_match_jax(runs, name):
    """The prefill cell, then 8 teacher-forced decode steps past the
    ring's wrap, on the mesh: every rank's gathered logits match the JAX
    model's ``prefill`` / ``decode_step`` on one device at rtol 1e-4, and
    every block a rank holds has its sharding's shape and equals the
    whole leaf's slice."""
    _cells_match_jax(runs(name), _serve_case(MESHES[name]["case"]))


def test_encoder_frames_that_do_not_divide_the_ranks(runs):
    """Whisper (reduced) with 62 frames on (1, 4): trained (3 steps) and
    served (prefill, 8 decode steps) through the cut, its encoder over
    rows padded to 64; against the JAX Trainer and model at rtol 1e-4."""
    ranks = runs("1x4")
    _trainer_matches_jax(ranks, WHISPER)
    _cells_match_jax(ranks, _serve_case(WHISPER))


def _trainer_matches_jax(ranks, case):
    """Every rank's losses, grad norms and parameters the same, and rank
    0's against the JAX Trainer's; returns the JAX final parameters in
    the port's layout."""
    tag = case["tag"]
    for out in ranks[1:]:
        for key in ("loss", "grad_norm", "lr", "params"):
            np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                          ranks[0][f"{tag}_{key}"])
    want, jparams, jv = _jax_train(case)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(ranks[0][f"{tag}_{key}"], want[key],
                                   rtol=1e-4)
    final = _port_params(jparams, case)
    params_close_tiny_v(ranks[0][f"{tag}_params"], flat(final),
                        tree_leaves(final), flat(_port_params(jv, case)),
                        sum(want["lr"]))
    return final


def _cells_match_jax(ranks, case):
    tag = case["tag"]
    jcfg = serve_case_cfg(jax_arch(case["arch"]).reduced(), case)
    tree = numpy_params(jax_build(jcfg, JaxOptions(dtype=jnp.float32,
                                                   scan_layers=False)))
    want = _jax_logits(dict(case, factor=None), tree)
    assert want.shape[1] == 1 + T
    for out in ranks:
        assert out[f"{tag}_param_blocks_ok"]
        assert out[f"{tag}_cache_blocks_ok"]
        np.testing.assert_allclose(out[f"{tag}_logits"], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", list(MESHES))
def test_expert_tp_layer_collectives(runs, name):
    """From the cut's log: in training, each microbatch gathers every MoE
    layer's rows once and reduce-scatters its output once (the layer's
    aux all-reduces ride the DP axes), and under remat "full" gathers
    them once more in the recompute; in the prefill cell one pair a
    layer; a decode step all-reduces the partial sums (not
    logged); no MoE all-to-all in any cell."""
    ranks = runs(name)
    case = MESHES[name]["case"]
    tag, stag = case["tag"], _serve_case(case)["tag"]
    per_layer = [["gather", 0], ["scatter", 0]]
    micro = per_layer * LAYERS
    if case["remat"] == "full":
        # the backward's recompute gathers each layer's rows again; it
        # stops (non-reentrant checkpoint) before the output's
        # reduce-scatter, which saves nothing for the backward
        micro += [["gather", 0]] * LAYERS
    for out in ranks:
        log = json.loads(str(out[f"{tag}_a2a"]))
        assert log == micro * case["accum"] * SPEC["steps"]
        prefill, decode = json.loads(str(out[f"{stag}_cut_log"]))
        assert prefill == per_layer * LAYERS and decode == []
        assert out[f"{stag}_moe_a2a"].tolist() == [0, 0]

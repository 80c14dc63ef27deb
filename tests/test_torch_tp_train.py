"""Tensor-parallel training of the port on gloo ranks against the JAX
``Trainer`` without a mesh.

Reduced Qwen3-8B (qk-norm, untied; its 2 KV heads replicated at tp 4) and
reduced Granite-3-2B (tied), and Granite with a vocab of 257 (the rules
replicate the vocab), train on ("data", "model") meshes (1, 2), (2, 2),
(1, 4) and on ("pod", "data", "model") (2, 1, 2), at ``accum_steps`` 1
and 2, scanned and unrolled, remat "none" and "full", the fused and the
unfused loss, float32: 3 steps
match the JAX Trainer's losses, grad norms and parameters at rtol 1e-4
(parameters loaded through ``params_from_jax`` from one numpy draw, as
``tests/test_torch_trainer.py`` does), every rank reports the same, and
each rank's blocks are bit-equal to the slices of the one-rank tree.

The other families' jobs (``...f``) do the same for reduced Mamba-2
(scanned and unrolled), RecurrentGemma, Whisper-base and LLaVA-NeXT-34B
(16 patches before 24 tokens: 40 rows, so at tp 2 and 4 a rank's block
holds patches and text), with two variants that take the replicated
branches of the cut at tp 4: RecurrentGemma with 6 query heads (its 10
at full width do not divide 4 either; at tp 2 they shard, over one
replicated KV head) and Mamba-2 with 6 SSD heads of 64 over a
``d_inner`` of 384 (expand 3: the columns shard, 96 a rank, the heads do
not). (Two heads of 128 over 256 would do too, but that model's 3-step
run is ill-conditioned: its grad norm jumps from 5.9 to 8.6 at the third
step, where the one-rank port already differs from JAX by 1e-4.) The JAX
Trainer's scans run their ``ref`` path under ``jax.grad``, as in
``tests/test_torch_trainer.py``. Reduced Mamba-2's embedding has entries
whose AdamW second moment is at the rounding scale, where the one-rank
port already differs from JAX by 3e-3 of the leaf's largest entry: its
parameters are held by ``tests/test_torch_trainer.py::
test_moe_trainer_matches_jax``'s rule (:func:`_mamba_params_close`).

The elastic path: a (2, 2) TP trainer's checkpoint restores bit for bit
onto (2, 1), (1, 2) and no mesh, and into the JAX Trainer; 2 more steps on
each mesh match a one-rank trainer restored from the same checkpoint. A
(2, 2) RecurrentGemma trainer's checkpoint restores the same way.

Each spawn (``tests/_torch_dist.py``) has one deadline, so a hung
collective fails the test instead of hanging it.
"""
from __future__ import annotations

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist import (CASE_OVERRIDES, case_cfg, flat, params_close,
                         spawn, tp_init_key, tp_run)
from _torch_jax import numpy_params

from repro.config.base import ParallelConfig as JaxParallel
from repro.config.base import RunConfig as JaxRun
from repro.config.base import TrainConfig as JaxTrain
from repro.config.registry import get_arch as jax_arch
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.optim import adamw_init as jadamw_init
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import leaf_paths, tree_leaves
from repro_torch.models.model import build_model
from repro_torch.optim import adamw_init
from repro_torch.runtime.trainer import Trainer

SPAWN_DEADLINE_S = 180
SPEC = dict(steps=3, global_batch=8, seq_len=16, lr=5e-3, total_steps=6)


def _case(tag, arch, accum, scan=False, remat="none", vocab=None, **kw):
    return dict(tag=tag, arch=arch, accum=accum, scan=scan, remat=remat,
                vocab=vocab, **kw)


Q, G = "qwen3-8b", "granite-3-2b"
JOBS = {
    "1x2": dict(mesh=[1, 2], axes=["data", "model"], cases=[
        _case("q1", Q, 1), _case("g2", G, 2, scan=True),
        _case("v1", G, 1, vocab=257, unfused=True)]),
    "2x2": dict(mesh=[2, 2], axes=["data", "model"], cases=[
        _case("q1", Q, 1, scan=True, remat="full", save=True),
        _case("q2", Q, 2), _case("g1", G, 1), _case("v2", G, 2, vocab=257)],
        seed=_case("s", Q, 1, scan=True)),
    "1x4": dict(mesh=[1, 4], axes=["data", "model"], cases=[
        _case("q1", Q, 1), _case("q2", Q, 2, scan=True, remat="full"),
        _case("g1", G, 1), _case("v1", G, 1, vocab=257)],
        seed=_case("s", Q, 1)),
    "2x1x2": dict(mesh=[2, 1, 2], axes=["pod", "data", "model"], cases=[
        _case("q2", Q, 2), _case("g1", G, 1, remat="full")]),
}
M, R = "mamba2-780m", "recurrentgemma-2b"
W, L = "whisper-base", "llava-next-34b"
LS = 24     # LLaVA's tokens a row: 16 patches + 24 = 40 rows
JOBS.update({
    "1x2f": dict(mesh=[1, 2], axes=["data", "model"], cases=[
        _case("m1", M, 1), _case("r2", R, 2, remat="full"),
        _case("w1", W, 1), _case("l1", L, 1, seq=LS),
        _case("rh1", R, 1, heads=6)]),
    "2x2f": dict(mesh=[2, 2], axes=["data", "model"], cases=[
        _case("m1", M, 1, scan=True, remat="full"),
        _case("r1", R, 1, save=True), _case("w2", W, 2, remat="full"),
        _case("l2", L, 2, seq=LS)],
        seed=_case("s", R, 1)),
    "1x4f": dict(mesh=[1, 4], axes=["data", "model"], cases=[
        _case("m2", M, 2), _case("mh1", M, 1, ssm_head_dim=64, ssm_expand=3),
        _case("r1", R, 1), _case("rh1", R, 1, heads=6, remat="full"),
        _case("w1", W, 1, remat="full"),
        _case("l1", L, 1, seq=LS, unfused=True)]),
    "2x1x2f": dict(mesh=[2, 1, 2], axes=["pod", "data", "model"], cases=[
        _case("m2", M, 2, scan=True), _case("r1", R, 1, remat="full"),
        _case("w1", W, 1), _case("l2", L, 2, seq=LS, remat="full")]),
})
CASES = [(job, c["tag"]) for job, spec in JOBS.items() for c in spec["cases"]]
# the (2, 2) trainers whose checkpoints the elastic jobs restore
SAVED = ("2x2", "q1")
SAVED_HYBRID = ("2x2f", "r1")
ELASTIC = {"elastic": SAVED, "elastic_hybrid": SAVED_HYBRID}
ELASTIC_MESHES = [[2, 1], [1, 2]]


def _cfgs(case):
    jcfg = case_cfg(jax_arch(case["arch"]).reduced(), case)
    run, opts = tp_run(SPEC, case, "unused")
    return jcfg, run, opts


def _numpy_tree(case):
    """The case's float32 parameters, drawn unrolled with numpy (a scanned
    draw takes fan_in = the layer count, ROADMAP.md Queue 3)."""
    jcfg, _, _ = _cfgs(case)
    return numpy_params(jax_build(jcfg, JaxOptions(dtype=jnp.float32,
                                                   scan_layers=False)))


def _port_params(tree, case):
    _, run, opts = _cfgs(case)
    return params_from_jax(tree, run.model, opts, "cpu")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX Trainer (no mesh, unrolled, float32) of each (arch, vocab,
    accum): losses, grad norms, final numpy parameters."""
    cache = {}

    def get(case):
        key = (case["arch"], case["accum"], case.get("seq"),
               *(case.get(k) for k in CASE_OVERRIDES))
        if key not in cache:
            jcfg, _, _ = _cfgs(case)
            train = {k: SPEC[k] for k in ("global_batch", "seq_len", "lr")}
            train["seq_len"] = case.get("seq", SPEC["seq_len"])
            jt = JaxTrainer(
                JaxRun(model=jcfg,
                       parallel=JaxParallel(accum_steps=case["accum"],
                                            remat="none", scan_layers=False),
                       train=JaxTrain(warmup_steps=2,
                                      total_steps=SPEC["total_steps"],
                                      checkpoint_every=10 ** 6, seed=3,
                                      **train)),
                options=JaxOptions(dtype=jnp.float32, scan_layers=False))
            jt.init_state()
            jt.params = jax.tree.map(jnp.asarray, _numpy_tree(case))
            jt.opt_state = jadamw_init(jt.params)
            jt.train(SPEC["steps"])
            cache[key] = ({k: [m[k] for m in jt.metrics_log]
                           for k in ("loss", "grad_norm", "lr")},
                          jax.tree.map(np.asarray, jt.params),
                          jax.tree.map(np.asarray, jt.opt_state["v"]))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """(workdir, per-rank results) of a JOBS job, or of an ELASTIC job (2
    ranks restoring its saved case's checkpoint onto ELASTIC_MESHES);
    each case's initial checkpoint is written to ``<workdir>/init_<key>``
    first."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        workdir = tmp_path_factory.mktemp(f"tp{name}")
        if name in ELASTIC:
            job_name, tag = ELASTIC[name]
            src_dir, _ = get(job_name)
            job = dict(mesh=[2], tp_elastic=dict(
                SPEC, src=str(src_dir / f"ck_{tag}"), at=SPEC["steps"],
                meshes=ELASTIC_MESHES, case=_find(job_name, tag), steps=2))
        else:
            spec = dict(SPEC, **JOBS[name])
            for case in spec["cases"]:
                d = workdir / f"init_{tp_init_key(case)}"
                if not d.exists():
                    p = _port_params(_numpy_tree(case), case)
                    save_checkpoint(str(d), 0, {"params": p,
                                                "opt": adamw_init(p)},
                                    extra={"data_step": 0})
            job = dict(mesh=spec["mesh"], tp_train=spec)
        cache[name] = workdir, spawn(job, None, workdir, SPAWN_DEADLINE_S)
        return cache[name]
    return get


def _find(job, tag):
    return next(c for c in JOBS[job]["cases"] if c["tag"] == tag)


@pytest.mark.parametrize("job,tag", CASES)
def test_tp_trainer_matches_jax(tp_runs, jax_runs, job, tag):
    """3 steps of the TP trainer from the JAX parameters: every rank
    reports the same losses, grad norms and full parameters, and they
    match the JAX Trainer without a mesh at rtol 1e-4 (parameters leaf by
    leaf, relative to each leaf's largest entry)."""
    _, ranks = tp_runs(job)
    case = _find(job, tag)
    for out in ranks[1:]:
        for key in ("loss", "grad_norm", "lr", "params"):
            np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                          ranks[0][f"{tag}_{key}"])
    want, jparams, jv = jax_runs(case)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(ranks[0][f"{tag}_{key}"], want[key],
                                   rtol=1e-4)
    final = _port_params(jparams, case)
    if case["arch"] == M:
        _mamba_params_close(ranks[0][f"{tag}_params"], final,
                            _port_params(jv, case), sum(want["lr"]))
    else:
        params_close(ranks[0][f"{tag}_params"], flat(final),
                     tree_leaves(final))


def _mamba_params_close(got, want, v, lr_sum, rtol=1e-4):
    """:func:`params_close`, except where JAX's AdamW second moment is
    below (1e3 * eps)^2 (``tests/test_torch_trainer.py::
    test_moe_trainer_matches_jax``'s rule): there AdamW divides a gradient
    of about eps by one of about eps, so last-bit differences of the
    gradient become O(1) differences of the step, and an entry may differ
    by up to the summed learning rates."""
    eps = JaxTrain().eps
    off = 0
    for w, vv in zip(tree_leaves(want), tree_leaves(v)):
        n = w.numel()
        a, b = got[off:off + n], w.detach().reshape(-1).numpy()
        vv = vv.detach().reshape(-1).numpy()
        tiny = (vv > 0) & (vv < (1e3 * eps) ** 2)
        np.testing.assert_allclose(a[~tiny], b[~tiny], rtol=rtol,
                                   atol=rtol * np.abs(b).max())
        assert (np.abs(a[tiny] - b[tiny]) <= lr_sum).all()
        off += n
    assert off == len(got)


def _slices(tree, index_json) -> np.ndarray:
    """`tree`'s leaves cut by each leaf's index ranges, flattened."""
    index = json.loads(str(index_json))
    parts = [leaf.detach()[tuple(slice(a, b) for a, b in ix)].reshape(-1)
             for leaf, ix in zip(tree_leaves(tree), index)]
    return torch.cat(parts).float().numpy()


@pytest.mark.parametrize("job", list(JOBS))
def test_tp_ranks_hold_their_blocks(tp_runs, job):
    """Each rank's blocks as restored are bit-equal to its slices of the
    one-rank tree, and the ranks' blocks differ where the rules shard;
    drawn from a seed, the blocks are the slices of the one-rank init of
    that seed (drawn leaf by leaf) and unshard back to it."""
    _, ranks = tp_runs(job)
    for case in JOBS[job]["cases"]:
        tag = case["tag"]
        full = _port_params(_numpy_tree(case), case)
        for out in ranks:
            np.testing.assert_array_equal(
                out[f"{tag}_blocks0"], _slices(full, out[f"{tag}_index"]))
        sizes = {len(out[f"{tag}_blocks0"]) for out in ranks}
        assert max(sizes) < sum(p.numel() for p in tree_leaves(full))
    if "seed" in JOBS[job]:
        _, run, opts = _cfgs(JOBS[job]["seed"])
        one = build_model(run.model, opts).init(5, "cpu")
        for out in ranks:
            np.testing.assert_array_equal(out["seed_blocks"],
                                          _slices(one, out["seed_index"]))
            np.testing.assert_array_equal(out["seed_full"], flat(one))


def _saved(tp_runs, saved=SAVED):
    """(case, checkpoint dir, its arrays) of a saved case."""
    workdir, _ = tp_runs(saved[0])
    ck = workdir / f"ck_{saved[1]}"
    with np.load(ck / f"step_{SPEC['steps']}" / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return _find(*saved), ck, arrays


def _from_arrays(arrays, prefix, like) -> np.ndarray:
    return np.concatenate([
        arrays["|".join([prefix, *map(str, p)])].reshape(-1)
        for p in leaf_paths(like)]).astype(np.float32)


def test_tp_checkpoint_restores_onto_smaller_meshes(tp_runs, tmp_path):
    """The (2, 2) trainer's checkpoint holds its final state; restored onto
    (2, 1) (data parallel), (1, 2) (tensor parallel) and no mesh, the
    parameters and AdamW moments are bit-equal to what was saved; 2 more
    steps on each mesh match a one-rank trainer restored from the same
    checkpoint at rtol 1e-4."""
    _check_restores(tp_runs, tmp_path, "elastic")


def test_hybrid_tp_checkpoint_restores_onto_smaller_meshes(tp_runs,
                                                           tmp_path):
    """As above for reduced RecurrentGemma trained on (2, 2): its RG-LRU
    width and MLP columns sharded, its heads and the recurrent vectors
    replicated."""
    _check_restores(tp_runs, tmp_path, "elastic_hybrid")


def _check_restores(tp_runs, tmp_path, name):
    job, tag = ELASTIC[name]
    case, ck, arrays = _saved(tp_runs, (job, tag))
    _, ranks22 = tp_runs(job)
    _, run, opts = _cfgs(case)
    like = build_model(run.model, opts).param_specs()
    saved = {k: _from_arrays(arrays, p, like)
             for k, p in (("params", "params"), ("m", "opt|m"),
                          ("v", "opt|v"))}
    np.testing.assert_array_equal(saved["params"],
                                  ranks22[0][f"{tag}_params"])
    shutil.copytree(ck, tmp_path / "ck")
    run, opts = tp_run(SPEC, case, tmp_path / "ck")
    one = Trainer(run, options=opts, device="cpu")
    assert one.restore_if_available() and one.step == SPEC["steps"]
    np.testing.assert_array_equal(flat(one.params), saved["params"])
    np.testing.assert_array_equal(flat(one.opt_state["m"]), saved["m"])
    np.testing.assert_array_equal(flat(one.opt_state["v"]), saved["v"])
    one.train(2)
    _, ranks = tp_runs(name)
    for shape in ELASTIC_MESHES:
        tag = "m" + "x".join(map(str, shape))
        for out in ranks:
            np.testing.assert_array_equal(out[f"{tag}_restored"],
                                          saved["params"])
            np.testing.assert_array_equal(out[f"{tag}_m"], saved["m"])
            np.testing.assert_array_equal(out[f"{tag}_v"], saved["v"])
            assert int(out[f"{tag}_opt_step"]) == SPEC["steps"]
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    out[f"{tag}_{key}"], [m[key] for m in one.metrics_log],
                    rtol=1e-4)
            params_close(out[f"{tag}_params"], flat(one.params),
                         tree_leaves(one.params))


def test_tp_checkpoint_restores_into_the_jax_trainer(tp_runs, tmp_path):
    """The JAX Trainer restores the (2, 2) TP trainer's checkpoint (the
    global arrays, scanned layout) bit for bit: parameters, moments, the
    optimizer step and the data position."""
    case, ck, arrays = _saved(tp_runs)
    jcfg, _, _ = _cfgs(case)
    shutil.copytree(ck, tmp_path / "ck")
    jt = JaxTrainer(
        JaxRun(model=jcfg, parallel=JaxParallel(scan_layers=True),
               train=JaxTrain(checkpoint_dir=str(tmp_path / "ck"),
                              global_batch=SPEC["global_batch"],
                              seq_len=SPEC["seq_len"])),
        options=JaxOptions(dtype=jnp.float32, scan_layers=True))
    assert jt.restore_if_available() and jt.step == SPEC["steps"]
    for prefix, tree in (("params", jt.params), ("opt|m", jt.opt_state["m"]),
                         ("opt|v", jt.opt_state["v"])):
        flat_j, _ = jax.tree_util.tree_flatten_with_path(tree)
        assert len(flat_j) == len([k for k in arrays
                                   if k.startswith(prefix + "|")])
        for path, leaf in flat_j:
            key = "|".join([prefix] + [str(getattr(k, "key", getattr(
                k, "idx", None))) for k in path])
            np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                          arrays[key])
    assert int(jt.opt_state["step"]) == SPEC["steps"]


def test_launcher_model_axis_checks_its_width(tmp_path, monkeypatch):
    """--model-axis needs a production mesh and must divide the ranks."""
    with pytest.raises(ValueError, match="--model-axis"):
        launch_train.main(["--arch", "qwen3-8b", "--device", "cpu",
                           "--model-axis", "2"])
    for k, v in dict(RANK="0", WORLD_SIZE="4", MASTER_ADDR="localhost",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="does not divide"):
        launch_train._launched_mesh(False, "cpu", 3)
    with pytest.raises(ValueError, match="does not divide"):
        launch_train._launched_mesh(True, "cpu", 4)


def test_launcher_trains_tensor_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh
    production --model-axis 2`` trains the reduced qwen3-8b on a (2, 2)
    ("data", "model") gloo mesh: every rank prints the same finite losses,
    and the checkpoint it writes (global arrays) restores into a one-rank
    Trainer at the step it was written."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(repo / "src")] + [p for p in [
                       os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", "qwen3-8b", "--mesh", "production", "--model-axis", "2",
         "--device", "cpu", "--steps", "2", "--checkpoint-dir",
         str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_DEADLINE_S, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    # the four ranks' lines may interleave in the shared pipe
    losses = re.findall(r"\[train\] loss (\S+) -> (\d+\.\d+)", out.stdout)
    assert len(losses) == 4 and len(set(losses)) == 1, out.stdout
    assert all(np.isfinite(float(x)) for x in losses[0])
    run = launch_train.build_run("qwen3-8b", steps=2,
                                 checkpoint_dir=str(tmp_path))
    one = Trainer(run, device="cpu")
    assert one.restore_if_available() and one.step == 2


def test_launcher_trains_mamba2_tensor_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 ... --arch mamba2-780m --mesh
    production --model-axis 2`` trains the reduced Mamba-2 on a (1, 2)
    ("data", "model") gloo mesh (its SSD heads and ``d_inner`` cut over
    the two ranks): both ranks print the same finite losses, and the
    checkpoint restores into a one-rank Trainer at the step it was
    written."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(repo / "src")] + [p for p in [
                       os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "mamba2-780m", "--mesh", "production", "--model-axis",
         "2", "--device", "cpu", "--steps", "2", "--checkpoint-dir",
         str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_DEADLINE_S, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = re.findall(r"\[train\] loss (\S+) -> (\d+\.\d+)", out.stdout)
    assert len(losses) == 2 and len(set(losses)) == 1, out.stdout
    assert all(np.isfinite(float(x)) for x in losses[0])
    run = launch_train.build_run("mamba2-780m", steps=2,
                                 checkpoint_dir=str(tmp_path))
    one = Trainer(run, device="cpu")
    assert one.restore_if_available() and one.step == 2

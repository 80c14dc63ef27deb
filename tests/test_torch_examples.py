"""The port's examples (``examples/torch_*.py``) run, each with
``--device cpu`` in a subprocess, as a user invokes them (as
``tests/test_examples.py`` runs the JAX package's), and each prints its
own check; without a card, the default device raises."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def run_example(args, tmp_path, timeout=300):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "2", "HOME": str(tmp_path)}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


@pytest.mark.parametrize("name,expect", [
    ("torch_quickstart", "fields identical: True"),
    ("torch_heat2d_hdot", "== plain blocked sweep: True"),
    ("torch_hpccg_cg", "relative residual"),
    ("torch_serve_lm", "10 requests, 120 tokens"),
])
def test_example_runs_on_the_cpu(name, expect, tmp_path):
    out = run_example([f"examples/{name}.py", "--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert expect in out.stdout, out.stdout[-2000:]


def test_train_lm_steps4_inside_warmup(tmp_path):
    out = run_example(["examples/torch_train_lm.py", "--preset", "2m",
                       "--steps", "4", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "ck")], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[torch_train_lm] OK" in out.stdout, out.stdout[-2000:]
    assert "inside warmup" in out.stdout, out.stdout[-2000:]


def test_example_asks_for_a_card_by_default(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_example(["examples/torch_hpccg_cg.py"], tmp_path)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr

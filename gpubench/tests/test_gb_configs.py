"""Each configuration file runs its source's published widths: the sizes
the program is given are worked out again from the published config and
the published code's defaults, which the file records under
``"published"``, and only the keys in ``reduced`` may differ."""
import dataclasses

import pytest

from gpubench import bench
from gpubench.workloads.train import model_config

WIDTHS = {"d_model", "head_dim", "d_ff", "state_dim", "expand",
          "num_heads", "num_kv_heads", "d_ff_expert", "top_k",
          "conv_kernel", "chunk_size", "lru_width"}


def _mamba2(published):
    """The program's sizes of a published mamba_ssm Mamba-2 model."""
    c, m = published["config.json"], published["Mamba2 defaults"]
    pad = c["pad_vocab_size_multiple"]
    assert c["ssm_cfg"]["layer"] == "Mamba2" and not c["attn_layer_idx"]
    assert c["d_intermediate"] == 0 and m["ngroups"] == 1
    return {"num_layers": c["n_layer"], "d_model": c["d_model"],
            "vocab_size": -(-c["vocab_size"] // pad) * pad,
            "tie_embeddings": c["tie_embeddings"],
            "norm_eps": published["norm_epsilon"],
            "ssm": {"state_dim": m["d_state"], "head_dim": m["headdim"],
                    "expand": m["expand"], "conv_kernel": m["d_conv"],
                    "chunk_size": m["chunk_size"]}}


FROM_SOURCE = {"ssm": _mamba2}
ENTRIES = [e for e in bench.benchmark()["configs"]
           if bench.load_json(bench.ROOT / e["file"])["family"] in FROM_SOURCE]


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda e: e["name"])
def test_config_runs_the_published_widths(entry):
    cfg = bench.load_json(bench.ROOT / entry["file"])
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert not WIDTHS & set(entry["reduced"])
    want = FROM_SOURCE[cfg["family"]](cfg["published"])
    differ = sorted(k for k, v in want.items() if cfg[k] != v)
    assert differ == sorted(set(entry["reduced"]) & set(want))
    built = model_config(cfg)       # what the program is given
    for key in want:
        got = getattr(built, key)
        if dataclasses.is_dataclass(got):
            got = dataclasses.asdict(got)
        assert got == cfg[key], key

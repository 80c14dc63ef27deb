"""LanguageModel: the public model API the server drives.

The port of ``repro/models/model.py`` for dense attention models:

  prefill(params, batch, max_len)         -- (logits of the last token, caches)
  decode_step(params, token, caches, pos) -- one token against the caches

Parameters are a :class:`~repro_torch.models.layers.ParamTree` in the JAX
package's layout (``init``, or :func:`repro_torch.models.convert.
params_from_jax`); caches are dicts of tensors that prefill and decode
update in place. The families ported are ``dense``, ``ssm`` (Mamba-2) and
``hybrid`` (RecurrentGemma); the others and training (``train_loss``) wait
for later slices (``ROADMAP.md``) and raise ``NotImplementedError``.

float32 runs on the card assume full-precision matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default); the
entry points set it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    ParamSpec,
    ParamTree,
    init_from_specs,
    rms_norm,
)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    attn_impl: str = "dense"          # dense | flash
    scan_layers: bool = True
    dtype: torch.dtype = torch.bfloat16


FAMILIES = ("dense", "ssm", "hybrid")


class LanguageModel:
    def __init__(self, cfg: ModelConfig, options: Optional[ModelOptions] = None):
        if cfg.family not in FAMILIES:
            raise tfm._not_ported(f"model family {cfg.family!r}")
        self.cfg = cfg
        self.opt = options or ModelOptions()

    # ------------------------------------------------------------------ specs
    def param_specs(self) -> PyTree:
        cfg, dt = self.cfg, self.opt.dtype
        specs: Dict[str, Any] = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), dt,
                               scale=cfg.d_model ** -0.5),
            "layers": tfm.stack_specs(cfg, self.opt.scan_layers, dt),
        }
        specs.update(tfm._norm_specs(cfg, "final_norm"))
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dt)
        return specs

    def init(self, seed: int = 0, device="cuda") -> ParamTree:
        return ParamTree(init_from_specs(self.param_specs(), seed, device))

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens]
        # the scale is rounded to the activation dtype first, as in the JAX
        # package (11.3125 in bf16 at d_model 128)
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                device=x.device)

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
        else:
            logits = x @ params["lm_head"]
        return logits.float()

    # ---------------------------------------------------------------- forward
    def _forward(self, params, batch: Dict, mode: str, caches=None,
                 pos=None) -> Tuple[torch.Tensor, Any]:
        """Hidden states (before the final norm) and the caches. `mode` is
        "train" (full sequence, no cache), "prefill" or "decode"."""
        tokens = batch["token"] if mode == "decode" else batch["tokens"]
        x = self._embed(params, tokens)
        b, s, _ = x.shape
        if mode == "decode":
            # scalar pos: every slot at the same position (wave scheduler);
            # (b,) pos: per-slot positions (continuous batching)
            positions = None  # decode_attention builds them from pos
        else:
            positions = torch.arange(s, device=x.device).expand(b, s)
        return tfm.stack_apply(params["layers"], x, self.cfg, positions, mode,
                               caches, pos, self.opt.attn_impl)

    # ------------------------------------------------------------ entry points
    def prefill(self, params, batch: Dict, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
        """`max_len` sizes the ring caches for the decode phase that follows;
        without it the cache holds exactly the prompt and the FIRST generated
        token evicts prompt token 0. Returns ((b, 1, vocab) f32 logits of the
        last token, caches)."""
        b, s = batch["tokens"].shape
        caches = self.init_caches(b, max(s, max_len or 0),
                                  params["embed"].device)
        x, caches = self._forward(params, batch, "prefill", caches=caches)
        return self._unembed(params, x[:, -1:]), caches

    def decode_step(self, params, token: torch.Tensor, caches, pos
                    ) -> Tuple[torch.Tensor, Any]:
        """token (b, 1); pos a scalar or a per-slot (b,) tensor. Returns
        ((b, 1, vocab) f32 logits, caches updated in place)."""
        x, caches = self._forward(params, {"token": token}, "decode",
                                  caches=caches, pos=pos)
        return self._unembed(params, x), caches

    # ----------------------------------------------------------------- caches
    def cache_specs(self, batch: int, max_len: int) -> PyTree:
        return tfm.stack_cache_specs(self.cfg, batch, max_len,
                                     self.opt.scan_layers, self.opt.dtype)

    def init_caches(self, batch: int, max_len: int, device="cuda") -> PyTree:
        return init_from_specs(self.cache_specs(batch, max_len), 0, device)


# ------------------------------------------------------------------- factories
def build_model(cfg: ModelConfig, options: Optional[ModelOptions] = None
                ) -> LanguageModel:
    return LanguageModel(cfg, options)


def init_params(cfg: ModelConfig, seed: int = 0,
                options: Optional[ModelOptions] = None,
                device="cuda") -> ParamTree:
    return build_model(cfg, options).init(seed, device)

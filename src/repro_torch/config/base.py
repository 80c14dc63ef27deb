"""Model config dataclasses: the port's own copy of the JAX package's
``repro/config/base.py`` (the model part), so that the port imports nothing
of ``repro``. Pure Python, no torch.

The parallel/train/run configs wait for the training and multi-card slices
(``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # Per-expert FFN hidden size (qwen3-moe uses fine-grained 768-wide experts).
    d_ff_expert: int = 14336
    # Capacity factor used by the dense-dispatch (GShard-style) path.
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD / state-space duality) parameters."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2          # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk_size: int = 256    # SSD block size == HDOT sequence subdomain

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style hybrid: pattern of 'rglru' and 'attn' blocks."""

    # repeating block pattern; recurrentgemma uses (rglru, rglru, attn)
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")
    lru_width: Optional[int] = None   # defaults to d_model
    local_window: int = 2048          # local attention window
    conv_kernel: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder. The audio frontend is a STUB: input_specs
    provides precomputed frame embeddings (batch, enc_seq, d_model)."""

    enc_layers: int = 6
    enc_seq: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # defaults to d_model // num_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA window (mixtral: 4096)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    # vlm stub: number of image patch embeddings prepended to the sequence
    num_vision_patches: int = 0
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if the arch supports O(1)-state / bounded-window decode, i.e.
        long_500k is runnable (SWA, SSM, RG-LRU hybrid)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def num_params(self) -> int:
        """Total parameter count (embedding + per-layer weights). Used for the
        MODEL_FLOPS=6*N*D roofline term and for sanity-checking configs."""
        hd = self.resolved_head_dim
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def dense_ffn(d_ff: int) -> int:
            return 3 * d * d_ff  # SwiGLU: gate, up, down

        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + dense_ffn(self.d_ff)
            n_layers = self.num_layers
            total = per_layer * n_layers
        elif self.family == "moe":
            if self.moe is None:
                raise ValueError(
                    f"config {self.name!r}: family='moe' requires a MoEConfig "
                    f"on cfg.moe")
            ffn = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
            router = d * self.moe.num_experts
            total = (attn_params() + ffn + router) * self.num_layers
        elif self.family == "ssm":
            if self.ssm is None:
                raise ValueError(
                    f"config {self.name!r}: family='ssm' requires an "
                    f"SSMConfig on cfg.ssm")
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            # in_proj produces [z, x, B, C, dt]; out_proj back to d
            in_proj = d * (2 * di + 2 * self.ssm.state_dim + nh)
            out_proj = di * d
            conv = self.ssm.conv_kernel * (di + 2 * self.ssm.state_dim)
            total = (in_proj + out_proj + conv + 2 * nh) * self.num_layers
        elif self.family == "hybrid":
            if self.hybrid is None:
                raise ValueError(
                    f"config {self.name!r}: family='hybrid' requires a "
                    f"HybridConfig on cfg.hybrid")
            w = self.hybrid.lru_width or d
            rglru = d * 2 * w + w * d + 3 * w + self.hybrid.conv_kernel * w
            pat = self.hybrid.pattern
            n_attn = sum(1 for p in pat if p == "attn")
            n_rec = len(pat) - n_attn
            blocks = self.num_layers
            attn_blocks = blocks * n_attn // len(pat)
            rec_blocks = blocks - attn_blocks
            total = attn_blocks * (attn_params() + dense_ffn(self.d_ff)) + rec_blocks * (
                rglru + dense_ffn(self.d_ff)
            )
        elif self.family == "encdec":
            if self.encdec is None:
                raise ValueError(
                    f"config {self.name!r}: family='encdec' requires an "
                    f"EncDecConfig on cfg.encdec")
            dec = (2 * attn_params() + dense_ffn(self.d_ff)) * self.num_layers
            enc = (attn_params() + dense_ffn(self.d_ff)) * self.encdec.enc_layers
            total = dec + enc
        else:  # pragma: no cover - guarded by registry
            raise ValueError(f"unknown family {self.family}")
        return total + emb

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.num_params()
        if self.moe is None:
            raise ValueError(
                f"config {self.name!r}: family='moe' requires a MoEConfig "
                f"on cfg.moe")
        d = self.d_model
        inactive = (self.moe.num_experts - self.moe.top_k) * 3 * d * self.moe.d_ff_expert
        return self.num_params() - inactive * self.num_layers

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=256,
            sliding_window=64 if self.sliding_window else None,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=16, chunk_size=32)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, lru_width=128, local_window=32)
        if self.encdec is not None:
            kw["encdec"] = dataclasses.replace(self.encdec, enc_layers=2, enc_seq=64)
        if self.num_vision_patches:
            kw["num_vision_patches"] = 16
        return dataclasses.replace(self, **kw)

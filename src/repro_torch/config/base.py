"""Config dataclasses: the port's own copy of the JAX package's
``repro/config/base.py``, so that the port imports nothing of ``repro``.
Pure Python, no torch.

The fields, defaults and ``__post_init__`` checks are the JAX package's.
Every family's config is served and trained by the port (``runtime/
trainer.py``): data-parallel, ZeRO-3 (``param_shard``, ``fsdp_streaming``;
on a DP-only mesh, else ``ValueError``) or tensor-parallel on a "model"
axis. ``moe_a2a_chunks`` is read where the MoE blocks run expert
parallelism (a "model" axis of more than one rank that divides the
experts); on a data-parallel mesh MoE takes the dense dispatch and
ignores it, as in the JAX package. ``collective_matmul`` and
``grad_compression`` are read nowhere, in the JAX package too: a trainer
trains the same step with either set.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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


@dataclass(frozen=True)
class ParallelConfig:
    """How the model is laid out on the mesh. Axes are logical; launch/mesh.py
    materializes ("pod", "data", "model")."""

    # fsdp shards params/optstate over these axes (ZeRO-3); data parallel axes.
    dp_axes: Tuple[str, ...] = ("pod", "data")
    tp_axis: str = "model"
    # sequence-parallel activations between blocks (shard seq over tp_axis)
    sequence_parallel: bool = True
    # 'none'   = two-phase (paper's MPI+OpenMP baseline): whole-tensor collectives
    # 'hdot'   = per-subdomain collectives in the dataflow (the paper's technique)
    overlap: str = "hdot"
    # HDOT over-decomposition degree at task level (chunks per shard);
    # mirrors the paper's "number of subdomains per rank".
    subdomains: int = 4
    # gradient-sync buckets for the zero-copy HDOT schedule (subdomains of
    # the parameter domain; each bucket is one multi-operand all-reduce)
    grad_buckets: int = 8
    # bucket emission order for the explicit schedules:
    #   'reverse_topo' — buckets cut along layer boundaries (leaf provenance
    #                    from models/*), collectives emitted last-backward-
    #                    first so the first reduction departs while earlier
    #                    layers' backward still computes
    #   'tree'         — legacy size-balanced buckets in pytree order
    bucket_order: str = "reverse_topo"
    # ZeRO-3: park params/opt-state as bucket-wise flat buffers sharded over
    # dp_axes (1/|dp| per-device residency); the explicit step all-gathers
    # buckets forward-order and reduce-scatters them reverse-topologically.
    # Requires the explicit-schedule (DP-only mesh) step.
    param_shard: bool = False
    # Streaming ZeRO-3: cut ONE bucket per layer (bucket_order forced to
    # 'layer') and emit each bucket's all-gather inside the remat region of
    # the layer that consumes it — the gathered buffer dies after that
    # layer's forward and the backward REGATHERS it in reverse order, so
    # peak live params ≈ shard + fsdp_working_set buckets instead of the
    # full tree. Needs param_shard=True and scan_layers=False (layer
    # boundaries must be visible to the gather schedule).
    fsdp_streaming: bool = False
    # Bound on simultaneously-live gathered buckets the streaming schedule
    # promises (head bucket + the layer in flight). The lint target and the
    # memory probe assert it; the step itself emits gathers point-of-use.
    fsdp_working_set: int = 2
    scan_layers: bool = True
    remat: str = "full"                # 'none' | 'full' | 'dots'
    # gradient accumulation microbatches (1 = no accumulation)
    accum_steps: int = 1
    # use ppermute-ring collective matmul for TP instead of plain all-gather
    collective_matmul: bool = False
    # MoE expert-parallel a2a over-decomposition degree Q (core.a2a_scan):
    # the dispatch/combine all-to-alls are chunked into Q capacity slices so
    # slice k+1's dispatch and slice k-1's combine overlap slice k's expert
    # FFN. 1 = monolithic a2a (the two-phase baseline); must divide the
    # per-shard expert capacity C.
    moe_a2a_chunks: int = 1
    # int8 error-feedback compression on the cross-pod gradient hop
    grad_compression: str = "none"     # 'none' | 'int8_ef'
    # measured-cost dynamic re-partitioning: every K steps, re-cut the
    # interior chunk grid from per-chunk wall-clock EMAs (core/cost.py) and
    # recompile only if the cut changed. 0 = static uniform cut (off).
    rebalance_every: int = 0

    def __post_init__(self):
        if self.rebalance_every < 0:
            raise ValueError(
                f"rebalance_every must be >= 0, got {self.rebalance_every}")
        if self.fsdp_working_set < 1:
            raise ValueError(
                f"fsdp_working_set must be >= 1, got {self.fsdp_working_set}")
        if self.fsdp_streaming and not self.param_shard:
            raise ValueError(
                "fsdp_streaming=True needs param_shard=True (it is a "
                "schedule for the ZeRO-3 flat-shard step)")
        if self.fsdp_streaming and self.scan_layers:
            raise ValueError(
                "fsdp_streaming=True needs scan_layers=False: per-layer "
                "gather placement requires the unrolled stack (the scanned "
                "lowering streams via stack_apply's scan-carried gather)")
        if self.fsdp_streaming and self.remat != "full":
            raise ValueError(
                "fsdp_streaming=True needs remat='full': the backward must "
                "REGATHER each layer's bucket inside its remat region "
                "('none' would keep every gathered buffer live to its "
                "backward use; 'dots' saves the gathered dot operands — "
                "both forfeit the streaming memory bound)")


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

"""qwen3-moe-30b-a3b [moe] — 128 fine-grained experts top-8, qk-norm GQA.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.config.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert intermediate (fine-grained experts)
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)

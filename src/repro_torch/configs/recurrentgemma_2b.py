"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 (pattern rglru,rglru,attn).
MQA (kv=1). [arXiv:2402.19427; hf]"""
from repro_torch.config.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"), lru_width=2560, local_window=2048),
)

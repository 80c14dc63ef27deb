"""llava-next-34b [vlm] — anyres tiling; transformer BACKBONE only, the vision
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    # anyres base grid: 24x24 patches = 576 precomputed patch embeddings
    num_vision_patches=576,
)

"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.config.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,       # unused (attn-free); SSD heads come from SSMConfig
    num_kv_heads=1,
    d_ff=0,            # no FFN block: mamba2 block is the whole layer
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_kernel=4, chunk_size=256),
)

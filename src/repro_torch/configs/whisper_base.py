"""whisper-base [audio] — enc-dec; conv frontend is a STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.config.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,          # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    tie_embeddings=True,
    encdec=EncDecConfig(enc_layers=6, enc_seq=1500),
)

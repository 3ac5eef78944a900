"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab.  [arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    layout=(BlockSpec("attn", "mlp"),),
    rope_theta=500000.0,
    supports_decode=True,
    sub_quadratic=False,
    # 405B fp32 masters + fp32 Adam moments exceed 256 x 16GB HBM even
    # fully sharded; bf16 masters are the standard choice at this scale.
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="llama3-405b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab_size=256, remat="none")

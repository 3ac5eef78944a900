"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d (rotary on half the head dims), GQA.
[arXiv:2406.12793; hf]
"""
from repro_torch.configs.base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    layout=(BlockSpec("attn", "mlp"),),
    rope_variant="half",          # GLM 2d-RoPE collapses to half-rotary
    rope_theta=10000.0,
    supports_decode=True,
    sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="chatglm3-6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, remat="none")

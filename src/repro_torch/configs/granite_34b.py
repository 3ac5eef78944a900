"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code.  [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    layout=(BlockSpec("attn", "mlp"),),
    rope_theta=10000.0,
    supports_decode=True,
    sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="granite-34b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, remat="none")

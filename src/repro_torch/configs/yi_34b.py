"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
— llama-arch GQA.  [arXiv:2403.04652; hf]

Note: 56 Q-heads do not divide the model=16 mesh axis; the sharding
rules fall back to sharding the merged head*dim (7168 % 16 == 0) and let
GSPMD insert the (cheap, weight-side) resharding — see distrib/sharding.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    layout=(BlockSpec("attn", "mlp"),),
    rope_theta=5000000.0,
    supports_decode=True,
    sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="yi-34b-smoke",
    n_layers=2, d_model=56 * 2, n_heads=7, n_kv_heads=1, d_ff=128,
    vocab_size=256, remat="none")

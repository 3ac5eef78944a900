"""Layers: norms, RoPE, ternary dense, MLP, attention."""

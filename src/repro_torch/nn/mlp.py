"""Feed-forward blocks: SwiGLU / GELU MLPs with ternary weights."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.linear import TernaryPolicy, ternary_dense_apply


def mlp_apply(p, x: torch.Tensor, policy: TernaryPolicy,
              kind: str = "swiglu", compute_dtype=torch.bfloat16):
    if kind == "swiglu":
        g = ternary_dense_apply(p["gate"], x, policy, compute_dtype)
        u = ternary_dense_apply(p["up"], x, policy, compute_dtype)
        h = F.silu(g.float()).to(compute_dtype) * u
    else:
        u = ternary_dense_apply(p["up"], x, policy, compute_dtype)
        # the reference's jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(u.float(), approximate="tanh").to(compute_dtype)
    return ternary_dense_apply(p["down"], h, policy, compute_dtype)

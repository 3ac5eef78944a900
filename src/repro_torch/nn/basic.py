"""Norms, embeddings, rotary position embeddings."""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


def embedding_apply(p, ids: torch.Tensor,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather then cast (the same values as casting the table first)."""
    table = p["table"]
    return table[ids.to(table.device).long()].to(compute_dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     rotary_dim: Optional[int] = None,
                     device="cpu") -> torch.Tensor:
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, variant: str = "standard"
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable (..., seq).

    'standard' rotates all head_dim pairs ([first half, second half]);
    'half' (chatglm/GLM 2d) rotates the first half of head_dim only;
    'none' is a no-op.
    """
    if variant == "none":
        return x
    hd = x.shape[-1]
    rd = hd if variant == "standard" else hd // 2
    inv = rope_frequencies(hd, theta, rd, device=x.device)
    ang = positions.to(x.device)[..., None].float() * inv
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :rd].float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = torch.cat([rot, x[..., rd:].float()], dim=-1)
    return out.to(x.dtype)

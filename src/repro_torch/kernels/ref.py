"""Plain dense oracles for the TiM matmuls (tests only).

Independent of the S/T decomposition: dequantize and multiply, and for
the ADC fidelity mode count the +1 / -1 products of each L-row block
directly (the behavioral tile engine's ``block_counts``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.ternary import TernaryScales


def ternary_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                       w_scales: TernaryScales,
                       i_scales: Optional[TernaryScales] = None,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Exact weighted ternary matmul: dequantize then dense matmul."""
    w_real = torch.where(w_q > 0, w_scales.pos.float(),
                         w_scales.neg.float()) * w_q.float()
    if i_scales is None:
        x_real = x_q.float()
    else:
        x_real = torch.where(x_q > 0, i_scales.pos.float(),
                             i_scales.neg.float()) * x_q.float()
    return (x_real @ w_real).to(out_dtype)


def block_counts(inp_q: torch.Tensor, w_q: torch.Tensor, l_block: int = 16,
                 n_max: Optional[int] = None):
    """Per-block (n, k) counts of +1 / -1 products, clamped at n_max:
    inp_q (M, K), w_q (K, N) -> (M, K/l, N) int32 each."""
    pad = (-inp_q.shape[-1]) % l_block
    if pad:
        inp_q = F.pad(inp_q, (0, pad))
        w_q = F.pad(w_q, (0, 0, 0, pad))
    nb = inp_q.shape[-1] // l_block
    ib = inp_q.reshape(inp_q.shape[0], nb, l_block).to(torch.int32)
    wb = w_q.reshape(nb, l_block, -1).to(torch.int32)
    prod = ib[..., None] * wb[None]                    # (M, nb, l, N)
    n = (prod == 1).sum(-2, dtype=torch.int32)
    k = (prod == -1).sum(-2, dtype=torch.int32)
    if n_max is not None:
        n = n.clamp(max=n_max)
        k = k.clamp(max=n_max)
    return n, k


def ternary_matmul_saturating_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                                  w_scales: TernaryScales,
                                  i_scales: Optional[TernaryScales] = None,
                                  n_max: int = 8, l_block: int = 16,
                                  out_dtype=torch.float32) -> torch.Tensor:
    """ADC-fidelity oracle: per-block clamped counts, two-phase if needed."""
    w1 = w_scales.pos.float()
    w2 = w_scales.neg.float()

    def phase(xq_phase):
        n, k = block_counts(xq_phase, w_q, l_block, n_max)
        return (w1 * n.float() - w2 * k.float()).sum(-2)

    asym_w = not w_scales.symmetric
    asym_i = i_scales is not None and not i_scales.symmetric
    if asym_w or asym_i:
        i1 = i_scales.pos.float() if i_scales is not None else 1.0
        i2 = i_scales.neg.float() if i_scales is not None else 1.0
        pos = (x_q > 0).to(torch.int8)
        neg = (x_q < 0).to(torch.int8)
        out = i1 * phase(pos) - i2 * phase(neg)
    else:
        out = phase(x_q)
        if i_scales is not None:
            out = out * i_scales.pos.float()
    return out.to(out_dtype)

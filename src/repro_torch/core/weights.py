"""TernaryWeight: the serving-time container for a ternary weight matrix.

Raw int8 codes (1 B/weight) or 2-bit packed codes (0.25 B/weight) plus
the encoding scales; what the model's projections hold after
ternarization and what the TiM matmuls consume.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.packing import CODES_PER_BYTE, pack2b, unpack2b
from repro_torch.core.ternary import TernaryScales, ternarize


@dataclasses.dataclass
class TernaryWeight:
    """A (K, N) ternary weight matrix in code form.

    data   : int8 (K, N) codes, or uint8 (ceil(K/4), N) packed codes
    scales : TernaryScales with pos/neg broadcastable to (N,)
    packed : whether ``data`` is 2-bit packed along K
    k_dim  : the logical K (slices off pack padding)
    """

    data: torch.Tensor
    scales: TernaryScales
    packed: bool = False
    k_dim: Optional[int] = None

    @property
    def shape(self):
        k = self.k_dim if self.k_dim is not None else (
            self.data.shape[-2] * (CODES_PER_BYTE if self.packed else 1))
        return tuple(self.data.shape[:-2]) + (k, self.data.shape[-1])

    @property
    def nbytes_hbm(self) -> int:
        return self.data.numel() * self.data.element_size()

    def codes(self) -> torch.Tensor:
        """int8 codes, unpacked and sliced to ``k_dim`` if necessary."""
        if not self.packed:
            return self.data
        ax = self.data.ndim - 2
        q = unpack2b(self.data, axis=ax)
        if self.k_dim is not None and q.shape[ax] != self.k_dim:
            q = q.narrow(ax, 0, self.k_dim)
        return q

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        q = self.codes()
        return (torch.where(q > 0, self.scales.pos, self.scales.neg)
                * q.to(dtype)).to(dtype)


def pack_codes(q: torch.Tensor, scales: TernaryScales, k_dim: int,
               pack: bool) -> TernaryWeight:
    """Wrap (K, N) codes, 2-bit packing along K (zero-padded to % 4)."""
    if not pack:
        return TernaryWeight(q, scales, False, k_dim)
    pad = (-k_dim) % CODES_PER_BYTE
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
    return TernaryWeight(pack2b(q, axis=q.ndim - 2), scales, True, k_dim)


def ternarize_weight(w: torch.Tensor, encoding: str = "symmetric",
                     per_channel: bool = True, pack: bool = False
                     ) -> TernaryWeight:
    """Quantize a real (K, N) matrix into a TernaryWeight.

    per_channel=True gives one scale per output column (axis 0 reduced).
    """
    axis = 0 if per_channel else None
    q, scales = ternarize(w, encoding, axis=axis)
    if per_channel:
        scales = TernaryScales(scales.pos.reshape(-1),
                               scales.neg.reshape(-1), scales.sym)
    return pack_codes(q, scales, w.shape[0], pack)

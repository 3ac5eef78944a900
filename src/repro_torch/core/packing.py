"""2-bit packing of ternary codes (the TPC's two-bit storage).

Four ternary codes per uint8 byte, field ``f`` of a byte at bits
``2f..2f+1`` holding code ``4*i + f`` of the packed axis.  Encoding per
2-bit field (the TPC truth table):

    00 -> 0     01 -> +1     11 -> -1     10 -> reserved (decodes to 0)
"""
from __future__ import annotations

import torch

CODES_PER_BYTE = 4


def _encode2(q: torch.Tensor) -> torch.Tensor:
    """{-1, 0, 1} int8 -> 2-bit field (0b00, 0b01, 0b11) as uint8."""
    nz = (q != 0).to(torch.uint8)
    neg = (q < 0).to(torch.uint8)
    return nz | (neg << 1)


def _decode2(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_encode2``; the reserved 0b10 decodes to 0."""
    return (bits == 1).to(torch.int8) - (bits == 3).to(torch.int8)


def _shifts(device) -> torch.Tensor:
    return torch.arange(CODES_PER_BYTE, dtype=torch.uint8,
                        device=device) * 2


def pack2b(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack ternary codes 4-per-byte along ``axis`` (length % 4 == 0)."""
    axis = axis % q.ndim
    size = q.shape[axis]
    if size % CODES_PER_BYTE:
        raise ValueError(f"pack axis {axis} size {size} not divisible by 4")
    enc = _encode2(q).movedim(axis, -1)
    enc = enc.reshape(enc.shape[:-1] + (size // CODES_PER_BYTE,
                                        CODES_PER_BYTE))
    packed = (enc << _shifts(q.device)).sum(-1).to(torch.uint8)
    return packed.movedim(-1, axis).contiguous()


def unpack2b(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of ``pack2b``: uint8 -> int8 codes (4x longer axis)."""
    axis = axis % p.ndim
    pm = p.movedim(axis, -1)
    fields = (pm[..., None] >> _shifts(p.device)) & 0b11
    q = _decode2(fields)
    q = q.reshape(q.shape[:-2] + (q.shape[-2] * CODES_PER_BYTE,))
    return q.movedim(-1, axis).contiguous()


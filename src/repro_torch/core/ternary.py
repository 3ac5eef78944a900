"""Ternary quantization: encodings, dequantization, activation codes.

Three ternary systems (TiM-DNN §III):

  * unweighted   {-1, 0, +1}
  * symmetric    {-a, 0, +a}        (TWN, a = mean(|w| : |w| > thr))
  * asymmetric   {-W2, 0, +W1}      (TTQ-style calibrated scales)

Codes are int8 in {-1, 0, +1}; real value = where(q > 0, W1*q, W2*q).
Serving only: the straight-through estimators of QAT are not ported.

Scalar constants enter the arithmetic in the tensor's own dtype (a
bf16 weight is thresholded against ``bf16(0.7) * bf16(mean)``), which is
how the JAX reference rounds them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

UNWEIGHTED = "unweighted"
SYMMETRIC = "symmetric"
ASYMMETRIC = "asymmetric"

TWN_THRESHOLD_FACTOR = 0.7

Axis = Union[None, int, Tuple[int, ...]]


@dataclasses.dataclass
class TernaryScales:
    """Positive/negative scales: scalar () or per output channel (N,).

    ``sym`` marks pos == neg, which lets the matmul take the
    single-phase route.
    """

    pos: torch.Tensor
    neg: torch.Tensor
    sym: bool = False

    @property
    def symmetric(self) -> bool:
        return self.sym


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-d tensor of ``like``'s dtype and device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def dequantize(q: torch.Tensor, scales: TernaryScales,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    qf = q.to(dtype)
    return torch.where(q > 0, scales.pos.to(dtype) * qf,
                       scales.neg.to(dtype) * qf)


def _dims(axis: Axis, ndim: int):
    if axis is None:
        return tuple(range(ndim))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _reduce_mean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Mean in float32, rounded to ``x.dtype`` (keepdims unless axis=None)."""
    m = x.float().mean(dim=_dims(axis, x.ndim), keepdim=axis is not None)
    return m.to(x.dtype)


def _threshold(w: torch.Tensor, axis: Axis, factor: float) -> torch.Tensor:
    return _const(factor, w) * _reduce_mean(w.abs(), axis)


def _masked_mean(w: torch.Tensor, mask: torch.Tensor,
                 axis: Axis) -> torch.Tensor:
    """mean(|w| : mask) along ``axis`` in ``w.dtype``; 0 where empty."""
    dims = _dims(axis, w.ndim)
    keep = axis is not None
    num = torch.where(mask, w.abs(), torch.zeros_like(w)).float().sum(
        dim=dims, keepdim=keep).to(w.dtype)
    den = mask.sum(dim=dims, keepdim=keep).clamp_min(1)
    return num / den.to(w.dtype)


def ternarize_unweighted(w: torch.Tensor,
                         threshold_factor: float = TWN_THRESHOLD_FACTOR,
                         axis: Axis = None
                         ) -> Tuple[torch.Tensor, TernaryScales]:
    thr = _threshold(w, axis, threshold_factor)
    q = ((w > thr).to(torch.int8) - (w < -thr).to(torch.int8))
    one = _const(1.0, w)
    return q, TernaryScales(one, one, sym=True)


def ternarize_symmetric(w: torch.Tensor,
                        threshold_factor: float = TWN_THRESHOLD_FACTOR,
                        axis: Axis = None
                        ) -> Tuple[torch.Tensor, TernaryScales]:
    """TWN: codes sign(w) where |w| > thr, scale a = mean(|w| > thr)."""
    thr = _threshold(w, axis, threshold_factor)
    mask = w.abs() > thr
    q = torch.where(mask, torch.sign(w), torch.zeros_like(w)).to(torch.int8)
    a = _masked_mean(w, mask, axis)
    return q, TernaryScales(a, a, sym=True)


def ternarize_asymmetric(w: torch.Tensor,
                         threshold_factor: float = TWN_THRESHOLD_FACTOR,
                         axis: Axis = None
                         ) -> Tuple[torch.Tensor, TernaryScales]:
    """TTQ-style {-W2, 0, +W1}: independent positive / negative scales."""
    thr = _threshold(w, axis, threshold_factor)
    pos_mask = w > thr
    neg_mask = w < -thr
    q = pos_mask.to(torch.int8) - neg_mask.to(torch.int8)
    return q, TernaryScales(_masked_mean(w, pos_mask, axis),
                            _masked_mean(w, neg_mask, axis))


def ternarize(w: torch.Tensor, encoding: str = SYMMETRIC,
              threshold_factor: float = TWN_THRESHOLD_FACTOR,
              axis: Axis = None) -> Tuple[torch.Tensor, TernaryScales]:
    if encoding == UNWEIGHTED:
        return ternarize_unweighted(w, threshold_factor, axis)
    if encoding == SYMMETRIC:
        return ternarize_symmetric(w, threshold_factor, axis)
    if encoding == ASYMMETRIC:
        return ternarize_asymmetric(w, threshold_factor, axis)
    raise ValueError(f"unknown ternary encoding: {encoding!r}")


def quantize_act_ternary(x: torch.Tensor, threshold: float = 0.5
                         ) -> Tuple[torch.Tensor, TernaryScales]:
    """Inference-path ternary activation codes with unit scales."""
    thr = _const(threshold, x)
    q = (x > thr).to(torch.int8) - (x < -thr).to(torch.int8)
    one = _const(1.0, x)
    return q, TernaryScales(one, one, sym=True)


def quantize_act_unsigned(x: torch.Tensor, bits: int = 2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned codes round(clip(x, 0, 1) * (2^bits - 1)) and the step.

    The step ``1 / levels`` is rounded to ``x.dtype`` (bf16 on the
    serving path), exactly as the reference makes it.
    """
    levels = (1 << bits) - 1
    q = torch.round(x.clamp(0.0, 1.0) * _const(levels, x)).to(torch.int8)
    return q, _const(1.0 / levels, x)


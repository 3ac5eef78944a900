"""Dense and TernaryDense layers (serving forms).

Params are plain dicts: ``{"w": Tensor | TernaryWeight, "b": ...}``.
A TernaryWeight runs one of three serving modes, chosen by the policy:

  * ``act_mode='ternary'`` — activations become {-1, 0, 1} codes and
    the product runs through ``kernels.ops.tim_matmul`` (the single- or
    two-phase TiM kernel);
  * ``act_mode='int<bits>'`` — unsigned bit-serial activation codes
    through ``kernels.ops.tim_matmul_bitserial``;
  * ``act_mode='none'`` — weight-only: codes are dequantized and the
    product is a plain bf16 matmul (no kernel, as in the reference).

QAT (master weights under an enabled policy) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import ternary as T
from repro_torch.core.weights import TernaryWeight, pack_codes
from repro_torch.kernels import ops as kops

_MAX_ACT_BITS = 7  # unsigned codes must fit the kernels' int8 operands


@dataclasses.dataclass(frozen=True)
class TernaryPolicy:
    """How ternary layers behave (mirrors the reference field by field).

    ``impl`` picks the TiM matmul route: ``auto`` (the Hopper kernel for
    CUDA tensors, the plain version for CPU tensors), ``torch`` (always
    the plain version) or ``ref`` (dequantize-and-matmul oracle).
    """

    enabled: bool = True
    encoding: str = T.SYMMETRIC
    learned_scales: bool = False
    act_mode: str = "none"             # none | ternary | int<bits>
    act_threshold: float = 0.5
    n_max: Optional[int] = None        # ADC fidelity clamp (None = exact)
    pack: bool = False                 # 2-bit packed serve weights
    impl: str = "auto"
    fused: bool = True                 # single-launch multi-pass kernels

    def __post_init__(self):
        if self.act_mode not in ("none", "ternary"):
            if self._parse_bits(self.act_mode) is None:
                raise ValueError(
                    f"act_mode {self.act_mode!r}: expected 'none', "
                    f"'ternary', or 'int<bits>' with 1 < bits <= "
                    f"{_MAX_ACT_BITS}")

    @staticmethod
    def _parse_bits(mode: str) -> Optional[int]:
        if not (mode.startswith("int") and mode[3:].isdigit()):
            return None
        bits = int(mode[3:])
        return bits if 1 < bits <= _MAX_ACT_BITS else None

    @property
    def act_bits(self) -> Optional[int]:
        """Bit-serial activation width, or None for none/ternary."""
        return self._parse_bits(self.act_mode)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def draft(self, act_mode: str) -> "TernaryPolicy":
        """The cheap-encoding draft policy of self-speculative decoding:
        the same weight codes through a narrower activation path."""
        if not self.enabled:
            return self
        pol = self.replace(act_mode=act_mode)
        tb, db = self.act_bits, pol.act_bits
        if db is None and pol.act_mode == "none":
            raise ValueError(
                "draft act_mode 'none' is weight-only serving — it is "
                "not cheaper than the target and proposes from a "
                "different (full-precision-activation) distribution; "
                "pick 'ternary' or 'int<bits>'")
        if tb is not None and db is not None and db > tb:
            raise ValueError(
                f"draft act_mode {act_mode!r} ({db} bits) is wider than "
                f"the target's {self.act_mode!r} ({tb} bits); the draft "
                f"must use the cheaper encoding")
        return pol


FP32 = TernaryPolicy(enabled=False)


def dense_apply(p, x: torch.Tensor, compute_dtype=torch.bfloat16):
    w = p["w"]
    if isinstance(w, TernaryWeight):
        w = w.dequantize(compute_dtype)
    y = x.to(compute_dtype) @ w.to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def ternary_dense_apply(p, x: torch.Tensor, policy: TernaryPolicy,
                        compute_dtype=torch.bfloat16):
    """Serving codes go through ``_serve_apply``; a disabled policy is a
    plain dense layer."""
    if isinstance(p["w"], TernaryWeight):
        return _serve_apply(p, x, policy, compute_dtype)
    if not policy.enabled:
        return dense_apply(p, x, compute_dtype)
    raise NotImplementedError(
        "QAT forward (master weights under an enabled ternary policy) is "
        "not ported; ternarize the params first (ternarize_model)")


def _serve_apply(p, x: torch.Tensor, policy: TernaryPolicy, compute_dtype):
    w: TernaryWeight = p["w"]
    if policy.act_mode == "ternary":
        qx, sx = T.quantize_act_ternary(x, policy.act_threshold)
        y = kops.tim_matmul(qx, w, sx, n_max=policy.n_max, impl=policy.impl,
                            fused=policy.fused, out_dtype=compute_dtype)
    elif policy.act_bits is not None:
        bits = policy.act_bits
        qa, step = T.quantize_act_unsigned(x, bits=bits)
        y = kops.tim_matmul_bitserial(qa, step, w, bits=bits,
                                      n_max=policy.n_max, impl=policy.impl,
                                      fused=policy.fused,
                                      out_dtype=compute_dtype)
    else:
        y = x.to(compute_dtype) @ w.dequantize(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def ternarize_dense_params(p, policy: TernaryPolicy):
    """Convert fp master dense params into serving form (codes + scales).

    Statistics are taken on the bf16 view of the master, as the
    reference's ``ternarize_model`` does.
    """
    w = p["w"]
    if isinstance(w, TernaryWeight) or not policy.enabled:
        return p
    if policy.learned_scales:
        raise NotImplementedError("learned TTQ scales are training state; "
                                  "not ported")
    wb = w.to(torch.bfloat16)
    q, scales = T.ternarize(wb, policy.encoding, axis=wb.ndim - 2)
    scales = T.TernaryScales(scales.pos.reshape(-1),
                             scales.neg.reshape(-1), scales.sym)
    out = {"w": pack_codes(q, scales, w.shape[-2], policy.pack)}
    if "b" in p:
        out["b"] = p["b"]
    return out

"""Dispatching wrappers for the TiM ternary matmuls.

The contract (every route agrees, see the reference's kernels/ops.py):

    out[m, n] = sum_k I(x_q[m, k]) * W(w_q[k, n])

with I/W the weighted ternary decodings, the optional per-L-block ADC
saturation (``n_max``), and two-phase execution when the encoding
demands it (asymmetric weights or asymmetric input scales).

Routes (``impl=``):

  * ``'auto'``  — the Hopper kernel (kernels/tim_matmul.py) for CUDA
    tensors; the plain version for CPU tensors;
  * ``'torch'`` — always the plain version (the S/T decomposition in
    torch ops; on the card it equals the kernel bit for bit);
  * ``'ref'``   — dequantize and matmul (kernels/ref.py, an oracle).

``fused=False`` keeps the reference's multi-launch route (one
single-phase launch per phase / per bit-plane) as the parity oracle of
the fused kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.ternary import TernaryScales
from repro_torch.core.weights import TernaryWeight
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tim_matmul as _tk

DEFAULT_BM = 128   # the reference kernels' M tile (traffic accounting)


def _as_vec(scale, n: int, device) -> torch.Tensor:
    s = torch.as_tensor(scale, device=device).to(torch.float32).reshape(-1)
    if s.shape[0] == 1 and n != 1:
        s = s.expand(n)
    return s.contiguous()


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.float32).reshape(())


def _pad_packed_k(xq: torch.Tensor, w: TernaryWeight) -> torch.Tensor:
    """Pad activations along K to the packed weight's padded K (zero
    codes are inert)."""
    kp = w.data.shape[0] * 4
    if kp != xq.shape[1]:
        xq = F.pad(xq, (0, kp - xq.shape[1]))
    return xq


def _check_impl(impl: str):
    if impl not in ("auto", "torch", "ref"):
        raise ValueError(f"impl {impl!r}: expected 'auto', 'torch' or 'ref'")


def _st(x, w: TernaryWeight, w1, w2, iscale, impl, **kw):
    """One kernel-shaped call: the wrapper ('auto') or the plain
    version ('torch')."""
    xq = _pad_packed_k(x, w) if w.packed else x
    if impl == "torch":
        return _tk.tim_st_plain(xq.contiguous(), w.data, w1, w2, iscale,
                                packed=w.packed, **kw)
    mode = kw.pop("mode")
    if mode == "single":
        return _tk.tim_matmul_single(xq.contiguous(), w.data, w1, w2,
                                     iscale[0], packed=w.packed, **kw)
    if mode == "phases":
        return _tk.tim_matmul_fused(xq.contiguous(), w.data, w1, w2,
                                    iscale[0], iscale[1], packed=w.packed,
                                    **kw)
    return _tk.tim_matmul_bitserial(xq.contiguous(), w.data, w1, w2,
                                    iscale[0], packed=w.packed, **kw)


def tim_matmul(x_q: torch.Tensor, w: TernaryWeight,
               i_scales: Optional[TernaryScales] = None,
               *, n_max: Optional[int] = None, impl: str = "auto",
               fused: bool = True, out_dtype=torch.float32) -> torch.Tensor:
    """Weighted ternary matmul: (..., K) codes x TernaryWeight(K, N)."""
    _check_impl(impl)
    lead = x_q.shape[:-1]
    n = w.shape[-1]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    dev = x2.device

    if impl == "ref":
        out = _ref.ternary_matmul_ref(x2, w.codes(), w.scales, i_scales,
                                      out_dtype) if n_max is None else \
            _ref.ternary_matmul_saturating_ref(x2, w.codes(), w.scales,
                                               i_scales, n_max,
                                               out_dtype=out_dtype)
        return out.reshape(lead + (n,))

    w1, w2 = _as_vec(w.scales.pos, n, dev), _as_vec(w.scales.neg, n, dev)
    asym_w = not w.scales.symmetric
    asym_i = i_scales is not None and not i_scales.symmetric
    need_t = asym_w
    i1 = _f32(i_scales.pos if i_scales is not None else 1.0, dev)
    i2 = _f32(i_scales.neg if i_scales is not None else 1.0, dev)
    kw = dict(need_t=need_t, n_max=n_max, out_dtype=out_dtype)

    if not (asym_i or asym_w):
        out = _st(x2, w, w1, w2, i1.reshape(1), impl, mode="single", **kw)
    elif fused:
        out = _st(x2, w, w1, w2, torch.stack([i1, i2]), impl,
                  mode="phases", **kw)
    else:
        pos = (x2 > 0).to(torch.int8)
        neg = (x2 < 0).to(torch.int8)
        out = (_st(pos, w, w1, w2, i1.reshape(1), impl, mode="single", **kw)
               - _st(neg, w, w1, w2, i2.reshape(1), impl, mode="single",
                     **kw))
    return out.reshape(lead + (n,))


def tim_matmul_bitserial(act_codes: torch.Tensor, act_step,
                         w: TernaryWeight, bits: int,
                         *, n_max: Optional[int] = None, impl: str = "auto",
                         fused: bool = True,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Bit-serial unsigned activations x ternary weights.

    ``fused=True`` applies every bit-plane against one weight read;
    ``fused=False`` is the one-launch-per-plane oracle route.
    """
    _check_impl(impl)
    if impl != "ref" and fused:
        lead = act_codes.shape[:-1]
        n = w.shape[-1]
        a2 = act_codes.reshape(-1, act_codes.shape[-1])
        dev = a2.device
        w1 = _as_vec(w.scales.pos, n, dev)
        w2 = _as_vec(w.scales.neg, n, dev)
        out = _st(a2, w, w1, w2, _f32(act_step, dev).reshape(1), impl,
                  mode="bits", need_t=not w.scales.symmetric, n_max=n_max,
                  bits=bits, out_dtype=out_dtype)
        return out.reshape(lead + (n,))

    acc = None
    for b in range(bits):
        plane = ((act_codes >> b) & 1).to(torch.int8)
        part = tim_matmul(plane, w, None, n_max=n_max, impl=impl,
                          fused=False, out_dtype=out_dtype)
        part = part * (2.0 ** b)
        acc = part if acc is None else acc + part
    return (acc * act_step).to(out_dtype)


# ---------------------------------------------------------------------------
# weight-traffic accounting
# ---------------------------------------------------------------------------

def weight_stream_stats(m: int, w: TernaryWeight,
                        i_scales: Optional[TernaryScales] = None,
                        *, bits: Optional[int] = None, fused: bool = True,
                        block_m: int = DEFAULT_BM) -> dict:
    """Analytic weight-byte traffic of one matmul of M rows (the
    reference's accounting: one full weight stream per M tile and per
    launch)."""
    asym_w = not w.scales.symmetric
    asym_i = i_scales is not None and not i_scales.symmetric
    if bits is None:
        launches = 2 if (asym_w or asym_i) else 1
    else:
        launches = bits * (2 if asym_w else 1)
    if fused:
        launches = 1
    m_steps = -(-m // min(block_m, max(8, m)))
    bytes_per_stream = w.nbytes_hbm * m_steps
    return {
        "launches": launches,
        "weight_bytes_per_stream": bytes_per_stream,
        "weight_bytes_streamed": launches * bytes_per_stream,
    }


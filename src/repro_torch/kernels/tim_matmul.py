"""TiM ternary matmul: Hopper kernel wrappers and their plain versions.

The CUDA kernels (``csrc/tim_matmul.cu``) replace the reference's four
Pallas kernels; each has a wrapper here with the reference's role and a
launch counter:

  ====================  ===========================================
  wrapper               reference (src/repro/kernels/tim_matmul.py)
  ====================  ===========================================
  tim_matmul_single     tim_matmul_pallas / tim_matmul_packed_pallas
  tim_matmul_fused      tim_matmul_fused_pallas (two-phase)
  tim_matmul_bitserial  tim_matmul_bitserial_fused_pallas
  ====================  ===========================================

Two kernels serve CUDA tensors, chosen by ``tim_path`` from the mode,
packing, clamp and shape alone: ``"tc"``, the s8 tensor-core kernel
(``tim_tc``: no ``n_max``, K and N multiples of 16; single-phase with
dense int8 weights, two-phase and bit-serial with dense or packed
ones), counted again in ``tim_single_tc``, ``tim_two_phase_tc`` and
``tim_bitserial_tc``; and ``"dp4a"``, the CUDA-core kernel
(``tim_accumulate`` + ``tim_epilogue``) for everything else.
``tim_tc_splits`` says how many K slices the tc kernel takes: 1 (the
epilogue fused, no workspace) where its column tiles (``TC_TILE_N``)
fill the card.

A wrapper launches a kernel for CUDA tensors and runs the plain version
(``tim_st_plain``, the S/T decomposition written with torch ops) for CPU
tensors.  The plain version runs on both devices; on the card it equals
both kernels bit for bit: the integer products are exact (float32
matmuls while |sum| < 2^24; K * 127 stays far below for every served K)
and the f32 epilogue is the same sequence of correctly rounded
operations.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.packing import CODES_PER_BYTE, unpack2b
from repro_torch.kernels import _build

L_BLOCK = 16
MODES = {"single": 0, "phases": 1, "bits": 2}

# launches per kernel (one table row each); reset by the caller
LAUNCHES = {"tim_single": 0, "tim_single_packed": 0, "tim_two_phase": 0,
            "tim_bitserial": 0, "tim_single_tc": 0, "tim_two_phase_tc": 0,
            "tim_bitserial_tc": 0}

TC_TILE = 128      # the tc kernel's rows and K codes per tile
# its columns per tile: the two-phase instance keeps 4 products (S and T
# of each phase) in registers, so its tiles are half as wide
TC_TILE_N = {"single": 128, "phases": 64, "bits": 128}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _int_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 codes through a float32 matmul."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return (a.float() @ w.float()).to(torch.int32)


def _clamped_st(a: torch.Tensor, w: torch.Tensor, n_max: int):
    """Per-L=16-block (S, T) of ``a @ w`` with (n, k) clamped at n_max,
    summed over blocks in int32: the ADC fidelity access of one pass."""
    m, k = a.shape
    pad = (-k) % L_BLOCK
    if pad:
        a = F.pad(a, (0, pad))
        w = F.pad(w, (0, 0, 0, pad))
    nb = a.shape[1] // L_BLOCK
    ab = a.float().reshape(m, nb, L_BLOCK).transpose(0, 1)
    # |x| in int8, as the Pallas kernels take it: |-128| wraps to -128
    aab = a.abs().float().reshape(m, nb, L_BLOCK).transpose(0, 1)
    wb = w.float().reshape(nb, L_BLOCK, -1)
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    s = torch.bmm(ab, wb)
    t = torch.bmm(aab, wb.abs())
    n = torch.clamp((t + s) * 0.5, max=n_max)
    kk = torch.clamp((t - s) * 0.5, max=n_max)
    return ((n - kk).to(torch.int32).sum(0, dtype=torch.int32),
            (n + kk).to(torch.int32).sum(0, dtype=torch.int32))


def _pass_st(a, w, need_t, n_max):
    if n_max is not None:
        return _clamped_st(a, w, n_max)
    s = _int_product(a, w)
    t = _int_product(a.abs(), w.abs()) if need_t else None
    return s, t


def _epilogue(s, t, w1, w2, i):
    """i * (cs*S + ct*T), cs = (w1+w2)*0.5, ct = (w1-w2)*0.5 (f32)."""
    out = (w1 + w2) * 0.5 * s.float()
    if t is not None:
        out = out + (w1 - w2) * 0.5 * t.float()
    return i * out


def tim_st_plain(x: torch.Tensor, w_data: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor, iscale: torch.Tensor, *, mode: str,
                 packed: bool, need_t: bool, n_max: Optional[int] = None,
                 bits: int = 0, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments).

    x: (M, K) int8 (K padded to the packed weight's 4*rows); w_data:
    (K, N) int8 or (K/4, N) uint8; w1/w2: (N,) f32; iscale: f32 (1,) or
    (2,) — [i1] or [i1, i2] for the two-phase mode (``bits`` planes for
    the bit-serial mode, which scales by its step ``iscale[0]``).
    """
    w = unpack2b(w_data, axis=0) if packed else w_data
    if n_max is not None:
        need_t = True
    i1 = iscale[0]
    if mode == "single":
        s, t = _pass_st(x, w, need_t, n_max)
        return _epilogue(s, t, w1, w2, i1).to(out_dtype)
    if mode == "phases":
        pos = x.clamp(min=0)
        neg = (-x).clamp(min=0)
        sp, tp = _pass_st(pos, w, need_t, n_max)
        sn, tn = _pass_st(neg, w, need_t, n_max)
        p1 = _epilogue(sp, tp, w1, w2, i1).to(out_dtype)
        p2 = _epilogue(sn, tn, w1, w2, iscale[1]).to(out_dtype)
        return (p1 - p2).to(out_dtype)
    if mode == "bits":
        if n_max is None:
            s, t = _pass_st(x, w, need_t, None)
        else:
            s = t = 0
            for b in range(bits):
                plane = ((x >> b) & 1).to(torch.int8)
                sb, tb = _clamped_st(plane, w, n_max)
                s = s + sb * (1 << b)
                t = t + tb * (1 << b)
        return _epilogue(s, t, w1, w2, i1).to(out_dtype)
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_TC_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                + [ctypes.c_void_p])


def _lib(name: str = "tim_matmul_launch", argtypes=_ARGTYPES):
    fn = getattr(_build.load("tim_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def tim_path(mode: str, packed: bool, n_max: Optional[int], m: int, n: int,
             k: int) -> str:
    """The kernel that serves a CUDA call: ``"tc"`` (s8 tensor cores: no
    clamp, K and N multiples of 16 so that every row is 16-byte aligned;
    single-phase with dense int8 weights, two-phase and bit-serial with
    dense or packed ones) or ``"dp4a"``."""
    if n_max is not None or (mode == "single" and packed):
        return "dp4a"
    if m >= 1 and n >= 16 and k >= 16 and n % 16 == 0 and k % 16 == 0:
        return "tc"
    return "dp4a"


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM):
    both kernels split K to fill them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def tim_tc_splits(m: int, n: int, k: int, sms: int,
                  tile_n: int = TC_TILE) -> int:
    """K slices of the tc kernel's grid on a card of ``sms`` SMs, for
    column tiles of ``tile_n`` (``TC_TILE_N[mode]``).  1 where the (row,
    column) tiles alone give at least one block to every other SM: the
    epilogue is fused and no workspace is zeroed.  Otherwise as many
    slices as keep one wave on the card (at most one per K tile), their
    int32 sums added into a workspace and finished by the epilogue
    pass."""
    tiles = -(-m // TC_TILE) * -(-n // tile_n)
    if 2 * tiles >= sms:
        return 1
    return max(1, min(-(-k // TC_TILE), sms // tiles))


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def tim_st_launch(x, w_data, w1, w2, iscale, *, mode: str, packed: bool,
                  need_t: bool, n_max: Optional[int] = None, bits: int = 0,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; same arguments as
    ``tim_st_plain``)."""
    m, k = x.shape
    n = w_data.shape[1]
    wk = k // CODES_PER_BYTE if packed else k
    if packed and k % CODES_PER_BYTE:
        raise ValueError(f"packed weights need K % 4 == 0, got K={k}")
    _check(x, "x", torch.int8)
    _check(w_data, "w", torch.uint8 if packed else torch.int8, (wk, n))
    _check(w1, "w1", torch.float32, (n,))
    _check(w2, "w2", torch.float32, (n,))
    _check(iscale, "iscale", torch.float32,
           (2,) if mode == "phases" else (1,))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported by the "
                         f"kernel (bf16 or f32)")
    if mode == "bits" and not 1 < bits <= 7:
        raise ValueError(f"bits={bits}: expected 1 < bits <= 7")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tim_path(mode, packed, n_max, m, n, k) == "tc":
        if x.data_ptr() % 16 or w_data.data_ptr() % 16:
            raise ValueError("x / w: the tc kernel needs 16-byte aligned "
                             "rows")
        splits = tim_tc_splits(m, n, k, sm_count(x.device), TC_TILE_N[mode])
        # int32 planes: S of each phase, then T of each
        planes = (2 if mode == "phases" else 1) * (2 if need_t else 1)
        acc = torch.zeros((planes, m, n), dtype=torch.int32,
                          device=x.device) if splits > 1 else None
        err = _lib("tim_tc_launch", _TC_ARGTYPES)(
            x.data_ptr(), w_data.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            iscale.data_ptr(), None if acc is None else acc.data_ptr(),
            out.data_ptr(), m, n, k, MODES[mode], int(packed), int(need_t),
            splits, int(out_dtype == torch.bfloat16), stream)
        _build.check(err, f"tim_matmul[{mode}, tc]")
        return out
    # int32 (S, T) workspace the kernel's K slices add into atomically
    planes = (2 if mode == "phases" else 1) * \
        (2 if need_t or n_max is not None else 1)
    acc = torch.zeros((planes, m, n), dtype=torch.int32, device=x.device)
    err = _lib()(x.data_ptr(), w_data.data_ptr(), w1.data_ptr(),
                 w2.data_ptr(), iscale.data_ptr(), acc.data_ptr(),
                 out.data_ptr(), m, n, k,
                 MODES[mode], int(packed), int(need_t),
                 -1 if n_max is None else int(n_max), int(bits),
                 int(out_dtype == torch.bfloat16), sm_count(x.device),
                 stream)
    _build.check(err, f"tim_matmul[{mode}]")
    return out


def _route(counter: str, x, w_data, *args, **kw):
    if not x.is_cuda:
        return tim_st_plain(x, w_data, *args, **kw)
    LAUNCHES[counter] += 1
    if tim_path(kw["mode"], kw["packed"], kw.get("n_max"), x.shape[0],
                w_data.shape[1], x.shape[1]) == "tc":
        LAUNCHES[counter + "_tc"] += 1
    return tim_st_launch(x, w_data, *args, **kw)


# ---------------------------------------------------------------------------
# wrappers (one per reference kernel)
# ---------------------------------------------------------------------------

def tim_matmul_single(x_q, w_data, w1, w2, i1, *, packed: bool,
                      need_t: bool, n_max: Optional[int] = None,
                      out_dtype=torch.float32):
    """Single-phase ternary matmul (rows 1 and 2 of the kernel table)."""
    return _route("tim_single_packed" if packed else "tim_single", x_q,
                  w_data, w1, w2, i1.reshape(1), mode="single",
                  packed=packed, need_t=need_t, n_max=n_max,
                  out_dtype=out_dtype)


def tim_matmul_fused(x_q, w_data, w1, w2, i1, i2, *, packed: bool,
                     need_t: bool, n_max: Optional[int] = None,
                     out_dtype=torch.float32):
    """Fused two-phase ternary matmul: one launch, one weight read."""
    iscale = torch.stack([i1.reshape(()), i2.reshape(())])
    return _route("tim_two_phase", x_q, w_data, w1, w2, iscale,
                  mode="phases", packed=packed, need_t=need_t, n_max=n_max,
                  out_dtype=out_dtype)


def tim_matmul_bitserial(act_codes, w_data, w1, w2, act_step, *, bits: int,
                         packed: bool, need_t: bool,
                         n_max: Optional[int] = None,
                         out_dtype=torch.float32):
    """Fused bit-serial matmul: all bit-planes in one launch."""
    return _route("tim_bitserial", act_codes, w_data, w1, w2,
                  act_step.reshape(1), mode="bits", packed=packed,
                  need_t=need_t, n_max=n_max, bits=bits,
                  out_dtype=out_dtype)

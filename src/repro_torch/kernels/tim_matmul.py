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

Three kernels serve CUDA tensors, chosen by ``tim_path`` from the mode,
packing, T, clamp and shape alone (no ``n_max``, K and N multiples of
16, for the first two):

  * ``"wgmma"``, the swap-AB s8 wgmma kernel (``tim_wg``): the
    single-phase product of packed weights without T (row 2), counted
    again in ``tim_single_packed_wgmma``; ``tim_wg_tile`` gives its
    token tile and ``tim_wg_splits`` its K slices;
  * ``"tc"``, the s8 ``mma.sync`` kernel (``tim_tc``): every other
    product, counted again in ``tim_single_tc``,
    ``tim_single_packed_tc``, ``tim_two_phase_tc`` and
    ``tim_bitserial_tc``; ``tim_tc_splits`` gives its K slices;
  * ``"dp4a"``, the CUDA-core kernel (``tim_accumulate`` +
    ``tim_epilogue``): ``n_max`` and the shapes the others do not take.

A K split is 1 (the epilogue fused, no workspace) where a kernel's
(row, column) tiles fill the card.

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
            "tim_bitserial": 0, "tim_single_tc": 0,
            "tim_single_packed_tc": 0, "tim_single_packed_wgmma": 0,
            "tim_two_phase_tc": 0, "tim_bitserial_tc": 0}

TC_TILE = 128      # the tc kernel's rows and K codes per tile
# its columns per tile: the two-phase instance keeps 4 products (S and T
# of each phase) in registers, so its tiles are half as wide
TC_TILE_N = {"single": 128, "phases": 64, "bits": 128}

WG_COLS = 128      # the wgmma kernel's W columns per block
WG_TILES = (8, 16, 32, 64, 128)   # its token tiles (wgmma N)
WG_MIN_SLICE = 4   # its fewest K tiles (of TC_TILE codes) per K slice


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
_WG_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])


def _lib(name: str = "tim_matmul_launch", argtypes=_ARGTYPES):
    fn = getattr(_build.load("tim_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def tim_path(mode: str, packed: bool, n_max: Optional[int], m: int, n: int,
             k: int, *, need_t: bool) -> str:
    """The kernel that serves a CUDA call: ``"wgmma"`` (the single-phase
    product of packed weights without T), ``"tc"`` (every other product)
    — both without the clamp, with K and N multiples of 16 so that every
    row is 16-byte aligned — or ``"dp4a"``."""
    if n_max is not None or not (m >= 1 and n >= 16 and k >= 16
                                 and n % 16 == 0 and k % 16 == 0):
        return "dp4a"
    if mode == "single" and packed and not need_t:
        return "wgmma"
    return "tc"


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


def tim_wg_tile(m: int) -> int:
    """The wgmma kernel's token tile (its wgmma N) for M rows: the
    smallest of ``WG_TILES`` that holds M, 128 (row tiles) above."""
    return next((t for t in WG_TILES if t >= m), WG_TILES[-1])


def tim_wg_splits(m: int, n: int, k: int, sms: int) -> int:
    """K slices of the wgmma kernel's grid on a card of ``sms`` SMs.  1
    where its (row, column) tiles give at least one block to every other
    SM: the epilogue is fused and no workspace is zeroed.  Otherwise as
    many slices as keep one wave on the card, each at least
    ``WG_MIN_SLICE`` K tiles long (fewer int32 atomics into the
    workspace, and a ring that has stages to overlap)."""
    tiles = -(-m // tim_wg_tile(m)) * -(-n // WG_COLS)
    if 2 * tiles >= sms:
        return 1
    return max(1, min(-(-k // TC_TILE) // WG_MIN_SLICE, sms // tiles))


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
                  out_dtype=torch.float32,
                  path: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; same arguments as
    ``tim_st_plain``).  ``path`` names the kernel (default: ``tim_path``'s
    answer); another one is taken only where it computes the call too:
    ``"dp4a"`` always, ``"tc"`` where the rule says ``"wgmma"`` (to time
    one against the other on the same inputs)."""
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
    rule = tim_path(mode, packed, n_max, m, n, k, need_t=need_t)
    if path is None:
        path = rule
    elif path != rule and path != "dp4a" and (path, rule) != ("tc", "wgmma"):
        raise ValueError(f"path {path!r} does not take this call "
                         f"(tim_path: {rule!r})")
    if path != "dp4a" and (x.data_ptr() % 16 or w_data.data_ptr() % 16):
        raise ValueError(f"x / w: the {path} kernel needs 16-byte aligned "
                         f"rows")
    if path == "wgmma":
        splits = tim_wg_splits(m, n, k, sm_count(x.device))
        acc = torch.zeros((m, n), dtype=torch.int32,
                          device=x.device) if splits > 1 else None
        err = _lib("tim_wg_launch", _WG_ARGTYPES)(
            x.data_ptr(), w_data.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            iscale.data_ptr(), None if acc is None else acc.data_ptr(),
            out.data_ptr(), m, n, k, tim_wg_tile(m), splits,
            int(out_dtype == torch.bfloat16), stream)
        _build.check(err, f"tim_matmul[{mode}, wgmma]")
        return out
    if path == "tc":
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
    path = tim_path(kw["mode"], kw["packed"], kw.get("n_max"), x.shape[0],
                    w_data.shape[1], x.shape[1], need_t=kw["need_t"])
    if path != "dp4a":
        LAUNCHES[f"{counter}_{path}"] += 1
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

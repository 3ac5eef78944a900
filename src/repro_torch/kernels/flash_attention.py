"""Contiguous GQA flash attention: the Hopper kernel and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` (the port of
the reference's ``flash_attention_pallas``) for CUDA tensors and runs
``flash_attention_plain`` — the port's contiguous online-softmax scan,
``nn/attention.chunked_attention`` from position 0, which the
reference's ``docs/kernels.md`` names as the kernel's XLA counterpart —
for CPU tensors.  Layout as the reference: q (B, Sq, H, D), k/v (B, Sk,
Hk, D), H % Hk == 0; causal masks are top-left aligned (query i sees
keys j <= i, both from 0).

Three kernels serve CUDA tensors, chosen by ``flash_path`` from the
dtype and head size alone (the C launcher refuses a shape the named
kernel does not take); each has a launch counter beside the entry
point's ``flash_attention``:

  ===========  ================================  ==========================
  path         kernel (csrc/flash_attention.cu)  takes
  ===========  ================================  ==========================
  ``wgmma``    ``flash_attn_wgmma_kernel``       bf16, D = 64 or 128
  ``mma``      ``flash_attn_kernel`` (mma.sync)  other bf16 D % 16 == 0,
                                                 D <= 128
  ``fma``      ``flash_attn_fma_kernel``         f32, and any other D
  ===========  ================================  ==========================

Tolerance kernel vs plain: the kernel takes the online softmax per
128-key (wgmma), 64-key (mma) or 32-key (fma) tile, P fed to P V as two
bf16 terms on the tensor cores, and sums dot products in another order
than the plain scan's ``chunk_kv`` chunks; all accumulate in f32 and
round once to the output type, so bf16 outputs agree to about one bf16
ulp (|diff| <= 2^-7 * |ref| + 2e-3 is asserted) and f32 outputs to f32
rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import _qscale
from repro_torch.nn.attention import chunked_attention

LAUNCHES = {"flash_attention": 0, "flash_wgmma": 0, "flash_mma": 0,
            "flash_fma": 0}
PATHS = {"fma": 0, "mma": 1, "wgmma": 2}    # the C launcher's path ids

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          chunk_kv: int = 1024) -> torch.Tensor:
    """Plain version: the online-softmax scan over ``chunk_kv``-position
    KV chunks (full attention when Sk fits one chunk)."""
    return chunked_attention(q, k, v, causal=causal, chunk_kv=chunk_kv,
                             q_offset=0)


def flash_path(dtype, d: int) -> str:
    """The kernel that serves a CUDA call of this dtype and head size."""
    if dtype == torch.bfloat16 and d in (64, 128):
        return "wgmma"
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= 128:
        return "mma"
    return "fma"


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention_launch(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel ``flash_path`` names (CUDA tensors only)."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected q (B,Sq,H,D), k/v (B,Sk,Hk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if not q.is_cuda or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("q: expected a bf16 or f32 CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {q.dtype} "
                             f"tensor on {q.device}")
    if tuple(k.shape) != (b, sk, hk, d) or v.shape != k.shape:
        raise ValueError(f"k/v: expected {(b, sk, hk, d)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    path = flash_path(q.dtype, d)
    grid_ok = -(-sq // 128) <= 65535 if path == "wgmma" else b * h <= 65535
    if h % hk or d % 4 or d > 256 or sq < 1 or sk < 1 or not grid_ok:
        raise ValueError(f"unsupported shape: B={b} Sq={sq} Sk={sk} H={h} "
                         f"Hk={hk} D={d}")
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, hk, d, int(causal),
                 int(q.dtype == torch.bfloat16), _qscale(d), PATHS[path],
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    return out


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Flash attention, causal or bidirectional, GQA; output in q.dtype.
    CUDA tensors launch the kernel; CPU tensors run the plain scan."""
    if q.is_cuda:
        LAUNCHES["flash_attention"] += 1
        LAUNCHES["flash_" + flash_path(q.dtype, q.shape[-1])] += 1
        return flash_attention_launch(q, k, v, causal=causal)
    return flash_attention_plain(q, k, v, causal=causal)

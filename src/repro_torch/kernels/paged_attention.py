"""Paged GQA attention: Hopper kernel wrapper and its plain version.

``paged_attention`` launches ``csrc/paged_attention.cu`` (the port of
the reference's ``paged_attention_pallas``) for CUDA tensors and runs
``paged_attention_plain`` — the chunk scan of the reference's
``_paged_chunked_attention`` — for CPU tensors.

Tolerance kernel vs plain: the kernel takes the online softmax per KV
block (block_size positions) and sums dot products in another order,
where the plain scan reduces over ``chunk_kv`` positions at a time; both
accumulate in f32 and round once to bf16 at the end, so outputs agree
to about one bf16 ulp (|diff| <= 2^-7 * |ref| + 2e-3 is asserted).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.nn.attention import (
    _group_queries, _online_softmax_scan, _query_positions, kv_dequantize)

LAUNCHES = {"paged_attention": 0}


def paged_attention_plain(q, k_pool, v_pool, block_tables, kv_valid_len, *, q_offset,
               chunk_kv: int, k_scale=None, v_scale=None,
               causal: bool = True) -> torch.Tensor:
    """Plain version: the paged online-softmax scan of the reference's
    ``_paged_chunked_attention`` (XLA route).  Chunk c gathers
    physical blocks ``block_tables[:, c*cb:(c+1)*cb]`` (cb = chunk_kv //
    block_size) at their logical positions."""
    b, sq, h, d = q.shape
    nb, bs, hk = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if chunk_kv % bs:
        raise ValueError(f"block_size {bs} must divide chunk_kv {chunk_kv}")
    cb = chunk_kv // bs
    nblk = block_tables.shape[1]
    pad_blk = (-nblk) % cb
    tbl = block_tables.long()
    if pad_blk:  # clamped in-gather; masked by kv_valid_len
        tbl = torch.nn.functional.pad(tbl, (0, pad_blk))
    nc = tbl.shape[1] // cb
    tc = tbl.reshape(b, nc, cb)
    quant = k_scale is not None
    qg = _group_queries(q, hk).float() * (d ** -0.5)
    qpos = _query_positions(q_offset, sq, q.device)
    vlen = kv_valid_len.to(q.device)

    def load_chunk(c):
        ids = tc[:, c].clamp(0, nb - 1)
        kj = k_pool[ids].reshape(b, chunk_kv, hk, d)
        vj = v_pool[ids].reshape(b, chunk_kv, hk, d)
        if quant:
            kj = kv_dequantize(kj, k_scale[ids].reshape(b, chunk_kv, hk),
                               q.dtype)
            vj = kv_dequantize(vj, v_scale[ids].reshape(b, chunk_kv, hk),
                               q.dtype)
        return kj, vj

    return _online_softmax_scan(qg, qpos, causal, vlen, nc, chunk_kv,
                                load_chunk, q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])


def _lib():
    fn = _build.load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _per_slot(v, b: int, device) -> torch.Tensor:
    t = torch.as_tensor(0 if v is None else v, device=device)
    return t.to(torch.int32).expand(b).contiguous()


def paged_attention_launch(q, k_pool, v_pool, block_tables, kv_valid_len,
                           *, q_offset=None, k_scale=None, v_scale=None,
                           causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only)."""
    b, sq, h, d = q.shape
    nb, bs, hk = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    quant = k_scale is not None
    dev = q.device
    if not q.is_cuda or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("q: expected a contiguous bf16 CUDA tensor")
    kv_dtype = torch.int8 if quant else torch.bfloat16
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != dev or t.dtype != kv_dtype or not t.is_contiguous() \
                or tuple(t.shape) != (nb, bs, hk, d):
            raise ValueError(f"{name}: expected contiguous {kv_dtype} "
                             f"{(nb, bs, hk, d)} on {dev}")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.device != dev or t.dtype != torch.bfloat16 \
                    or not t.is_contiguous() \
                    or tuple(t.shape) != (nb, bs, hk):
                raise ValueError(f"{name}: expected contiguous bf16 "
                                 f"{(nb, bs, hk)} on {dev}")
    if h % hk or d > 256 or bs > 32 or bs * d > 6144:
        raise ValueError(f"unsupported shape: H={h} Hk={hk} D={d} bs={bs}")
    tbl = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    nblk = tbl.shape[1]
    vlen = _per_slot(kv_valid_len, b, dev)
    qoff = _per_slot(q_offset, b, dev)
    out = torch.empty_like(q)
    dummy = q  # never read without quant
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 (k_scale if quant else dummy).data_ptr(),
                 (v_scale if quant else dummy).data_ptr(), tbl.data_ptr(),
                 vlen.data_ptr(), qoff.data_ptr(), out.data_ptr(), b, sq, h,
                 hk, d, nb, bs, nblk, int(causal), int(quant),
                 float(torch.tensor(d ** -0.5, dtype=torch.float32)),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention")
    return out


def paged_attention(q, k_pool, v_pool, block_tables, kv_valid_len, *,
                    q_offset=None, chunk_kv: int = 1024, k_scale=None,
                    v_scale=None, causal: bool = True) -> torch.Tensor:
    """In-kernel block-table paged attention (normalized output).

    q: (B, Sq, H, D); pools (num_blocks, block_size, Hk, D) (+ (nb, bs,
    Hk) scales for int8 KV); block_tables (B, nblk) int32, out-of-range
    entries clamped and masked by ``kv_valid_len`` (B,).  CUDA tensors
    launch the kernel; CPU tensors run the plain scan.
    """
    if q.is_cuda:
        LAUNCHES["paged_attention"] += 1
        return paged_attention_launch(
            q, k_pool, v_pool, block_tables, kv_valid_len,
            q_offset=q_offset, k_scale=k_scale, v_scale=v_scale,
            causal=causal)
    return paged_attention_plain(
        q, k_pool, v_pool, block_tables, kv_valid_len,
        q_offset=0 if q_offset is None else q_offset, chunk_kv=chunk_kv,
        k_scale=k_scale, v_scale=v_scale, causal=causal)

"""Attention ops: GQA, online-softmax chunked attention, paged mixed.

All functions take (batch, seq, heads, head_dim) tensors.  GQA never
materializes repeated KV heads: queries are grouped (B, S, Hk, G, D)
against the shared KV head.

Paged KV (``block_tables``): the cache is a global block pool
``(num_blocks, block_size, Hk, D)`` shared across requests; slot b's
logical block j lives at physical block ``block_tables[b, j]``.  Caches
larger than one ``chunk_kv`` go through the paged scan, routed by
``impl``: ``'auto'`` launches the Hopper kernel
(kernels/paged_attention.py) for CUDA tensors and runs the plain chunk
scan for CPU tensors; ``'torch'`` always runs the plain scan.  Caches
that fit one chunk use ``full_attention`` on the gathered view on every
route, as the reference does.

Token-packed layout (``packed_mixed_attention``): T single-token
queries, each with its segment (slot) id, validity length and offset;
paged caches keep the per-slot block table, which the packed kernel
indexes by segment inside the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _group_queries(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    if h % n_kv:
        raise ValueError(f"heads {h} not divisible by kv heads {n_kv}")
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _query_positions(q_offset, sq: int, device) -> torch.Tensor:
    """(1, Sq) positions for a scalar offset, (B, Sq) for per-batch."""
    off = torch.as_tensor(q_offset, device=device)
    ar = torch.arange(sq, device=device)
    if off.ndim == 0:
        return (ar + off)[None, :]
    return off[:, None] + ar[None, :]


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """int8 KV codes (..., Hk, D) x per-(token, head) scales (..., Hk):
    f32 multiply, then the compute-dtype cast (part of the contract)."""
    return (codes.float() * scale.float()[..., None]).to(dtype)


def paged_view(pool: torch.Tensor, block_tables: torch.Tensor
               ) -> torch.Tensor:
    """(num_blocks, bs, ...) pool x (B, nblk) table -> (B, nblk*bs, ...).
    Unassigned entries are clamped; the caller masks them."""
    nb = pool.shape[0]
    g = pool[block_tables.clamp(0, nb - 1).long()]
    b, nblk, bs = g.shape[:3]
    return g.reshape((b, nblk * bs) + tuple(g.shape[3:]))


def full_attention(q, k, v, causal: bool = True, q_offset=0,
                   kv_valid_len: Optional[torch.Tensor] = None,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """Reference attention (materializes all scores)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qg = _group_queries(q, hk).to(compute_dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(compute_dtype)) \
        * (d ** -0.5)
    if causal:
        qpos = _query_positions(q_offset, sq, q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, :, None] >= kpos[None, None, :]
        s = torch.where(mask[:, None, None], s, NEG_INF)
    if kv_valid_len is not None:
        kmask = torch.arange(sk, device=q.device)[None] \
            < kv_valid_len.to(q.device)[:, None]
        s = torch.where(kmask[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(compute_dtype))
    return o.reshape(b, sq, h, d).to(q.dtype)


def _online_softmax_scan(qg, qpos, causal, kv_valid_len, nc, ck,
                         load_chunk, out_dtype):
    """The flash recurrence over ``nc`` logical KV chunks of ``ck``
    positions.  qg: (B, Sq, Hk, G, D) pre-scaled f32 queries;
    ``load_chunk(c) -> (kj, vj)`` gives chunk c at logical positions
    [c*ck, (c+1)*ck)."""
    b, sq, hk, g, d = qg.shape
    dev = qg.device
    m = torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hk, g, sq, d), dtype=torch.float32, device=dev)
    for c in range(nc):
        kj, vj = load_chunk(c)
        kvpos = c * ck + torch.arange(ck, device=dev)
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, kj.float())
        if causal:
            mask = qpos[:, :, None] >= kvpos[None, None, :]
            s = torch.where(mask[:, None, None], s, NEG_INF)
        if kv_valid_len is not None:
            kmask = kvpos[None] < kv_valid_len[:, None]
            s = torch.where(kmask[:, None, None, None, :], s, NEG_INF)
        mj = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows: keep m finite so exp() stays 0-safe
        mj_safe = torch.clamp(mj, min=-1e29)
        p = torch.exp(s - mj_safe[..., None])
        corr = torch.exp(torch.clamp(m - mj_safe, max=0.0))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd", p, vj.float())
        acc = acc * corr[..., None] + pv
        m = mj
    out = acc / torch.clamp(l, min=1e-30)[..., None]          # (b,hk,g,sq,d)
    out = out.movedim(3, 1).reshape(b, sq, hk * g, d)
    return out.to(out_dtype)


def chunked_attention(q, k, v, causal: bool = True, chunk_kv: int = 1024,
                      q_offset=0, kv_valid_len=None, block_tables=None,
                      k_scale=None, v_scale=None, impl: str = "auto"):
    """Online-softmax attention, O(Sq * chunk_kv) score memory; with
    ``block_tables`` k/v are a paged pool (see module docstring)."""
    if block_tables is not None:
        return _paged_chunked_attention(q, k, v, block_tables, causal,
                                        chunk_kv, q_offset, kv_valid_len,
                                        k_scale, v_scale, impl)
    if k_scale is not None or v_scale is not None:
        raise ValueError("KV scales only page with block_tables")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if sk <= chunk_kv:
        return full_attention(q, k, v, causal, q_offset, kv_valid_len)
    pad = (-sk) % chunk_kv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid_len is None:
            kv_valid_len = torch.full((b,), sk, dtype=torch.int32,
                                      device=q.device)
    nc = k.shape[1] // chunk_kv
    qg = _group_queries(q, hk).float() * (d ** -0.5)
    qpos = _query_positions(q_offset, sq, q.device)

    def load_chunk(c):
        sl = slice(c * chunk_kv, (c + 1) * chunk_kv)
        return k[:, sl], v[:, sl]

    return _online_softmax_scan(qg, qpos, causal, kv_valid_len, nc,
                                chunk_kv, load_chunk, q.dtype)


def _paged_chunked_attention(q, k_pool, v_pool, block_tables, causal,
                             chunk_kv, q_offset, kv_valid_len,
                             k_scale=None, v_scale=None, impl="auto"):
    """Paged attention: one chunk -> full_attention on the gathered view;
    otherwise the kernel ('auto') or the plain scan ('torch')."""
    if kv_valid_len is None:
        raise ValueError("paged attention requires kv_valid_len")
    if impl not in ("auto", "torch"):
        raise ValueError(f"impl {impl!r}: expected 'auto' or 'torch'")
    bs = k_pool.shape[1]
    nblk = block_tables.shape[1]
    if nblk * bs <= chunk_kv:
        kg, vg = paged_view(k_pool, block_tables), \
            paged_view(v_pool, block_tables)
        if k_scale is not None:
            kg = kv_dequantize(kg, paged_view(k_scale, block_tables),
                               q.dtype)
            vg = kv_dequantize(vg, paged_view(v_scale, block_tables),
                               q.dtype)
        return full_attention(q, kg, vg, causal, q_offset, kv_valid_len)
    from repro_torch.kernels import paged_attention as _pk
    fn = _pk.paged_attention if impl == "auto" else _pk.paged_attention_plain
    return fn(q, k_pool, v_pool, block_tables, kv_valid_len,
              q_offset=q_offset, chunk_kv=chunk_kv, k_scale=k_scale,
              v_scale=v_scale, causal=causal)


def mixed_attention(q, k_cache, v_cache, kv_valid_len, q_offset,
                    chunk_kv: int = 1024, block_tables=None, k_scale=None,
                    v_scale=None, impl: str = "auto"):
    """S new tokens per slot at per-slot offsets ``q_offset`` attending
    causally over ``[0, kv_valid_len)`` — the engine's unified step."""
    return chunked_attention(q, k_cache, v_cache, causal=True,
                             chunk_kv=chunk_kv, q_offset=q_offset,
                             kv_valid_len=kv_valid_len,
                             block_tables=block_tables, k_scale=k_scale,
                             v_scale=v_scale, impl=impl)


def packed_mixed_attention(q, k_cache, v_cache, seg_ids, kv_valid_len,
                           q_offset, chunk_kv: int = 1024, block_tables=None,
                           k_scale=None, v_scale=None, impl: str = "auto"):
    """Token-packed mixed attention: q (T, 1, H, D), token t of segment
    ``seg_ids[t]`` (clamped to [0, slots-1]; bucket padding rides along
    with ``kv_valid_len == 0``) attends causally over ``[0,
    kv_valid_len[t])`` from position ``q_offset[t]`` — ``mixed_attention``
    at B = T, S = 1 against a per-token cache view, so each token's
    output is the padded grid's for that token.

    Contiguous caches (slots, S_max, Hk, D) take each token's segment
    row.  Paged caches keep the per-slot ``block_tables``: caches that
    fit one ``chunk_kv`` take ``full_attention`` on the gathered view;
    larger ones the packed kernel ('auto', CUDA tensors) or the plain
    scan on the per-token table rows ('torch', or CPU tensors)."""
    nslots = (block_tables.shape[0] if block_tables is not None
              else k_cache.shape[0])
    seg = seg_ids.to(q.device).long().clamp(0, nslots - 1)
    if block_tables is None:
        if k_scale is not None or v_scale is not None:
            raise ValueError("KV scales only page with block_tables")
        return chunked_attention(q, k_cache[seg], v_cache[seg], causal=True,
                                 chunk_kv=chunk_kv, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len)
    if impl not in ("auto", "torch"):
        raise ValueError(f"impl {impl!r}: expected 'auto' or 'torch'")
    if block_tables.shape[1] * k_cache.shape[1] <= chunk_kv:
        return _paged_chunked_attention(
            q, k_cache, v_cache, block_tables.to(q.device)[seg], True,
            chunk_kv, q_offset, kv_valid_len, k_scale, v_scale)
    from repro_torch.kernels import paged_attention as _pk
    fn = _pk.paged_packed_attention if impl == "auto" \
        else _pk.paged_packed_attention_plain
    return fn(q, k_cache, v_cache, block_tables, seg, kv_valid_len,
              q_offset=q_offset, chunk_kv=chunk_kv, k_scale=k_scale,
              v_scale=v_scale)

"""Paged GQA attention: Hopper kernel wrappers and their plain versions.

``paged_attention`` launches ``csrc/paged_attention.cu`` (the port of
the reference's ``paged_attention_pallas``) for CUDA tensors and runs
``paged_attention_plain`` — the chunk scan of the reference's
``_paged_chunked_attention`` — for CPU tensors.
``paged_packed_attention`` is the token-packed layout's route (the port
of ``paged_packed_attention_pallas``): T single-token queries, each
reading its segment's row of the per-slot table inside the kernel;
``paged_packed_attention_plain`` runs the same chunk scan on the
per-token table rows ``block_tables[seg]``, as the reference's XLA
oracle does.  The packed kernel's output for a token equals the mixed
kernel's output for that token bit for bit (the same compiled kernel).
``paged_attention_partials`` is the block-sharded path's route (the
port of ``paged_attention_pallas(normalize=False, logical_blocks=,
entry_valid=)``): un-normalized flash partials ``(o, m, l)`` over a
shard's compacted table; ``paged_attention_partials_plain`` is the
reference's XLA route for it (``distrib/decode_attn._local_partial`` on
the gathered blocks at their logical positions).

All three launch one split-KV walk and one merge kernel
(``paged_attention_run``): a row's table entries are cut into ranges of
``E`` entries (``_split``: a function of the table width and block size
alone), each range's partials go to scratch, and the merge takes the
ranges in ascending order by the log-sum-exp identity.

Tolerance kernel vs plain: the kernel takes the online softmax per 16
keys (32 on the f32 path), sums dot products in another order, feeds P
to P V as three bf16 terms on the tensor cores, and merges ranges,
where the plain scan reduces over ``chunk_kv`` positions at a time;
both accumulate in f32 and round once to the output type at the end, so
bf16 outputs agree to about one bf16 ulp (|diff| <= 2^-7 * |ref| + 2e-3
is asserted) and the partials to f32 rounding of the scores.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.nn.attention import (
    _group_queries, _online_softmax_scan, _query_positions, kv_dequantize)

LAUNCHES = {"paged_attention": 0, "paged_packed_attention": 0,
            "paged_attention_partials": 0}


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


_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 14
             + [ctypes.c_float, ctypes.c_void_p])

# split-KV ranges: at least RANGE_POSITIONS positions, at most MAX_RANGES
RANGE_POSITIONS = 256
MAX_RANGES = 32
_KV_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _lib():
    fn = _build.load("paged_attention").paged_attention_run
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _split(nblk: int, bs: int):
    """(E, R): table entries per range and ranges per row.  A function
    of the table width and block size alone, so a packed token and its
    padded-grid row walk the same ranges."""
    e = max(-(-RANGE_POSITIONS // bs), -(-nblk // MAX_RANGES))
    return e, -(-nblk // e)


def _per_slot(v, b: int, device) -> torch.Tensor:
    t = torch.as_tensor(0 if v is None else v, device=device)
    return t.to(torch.int32).expand(b).contiguous()


def _check_launch(q, k_pool, v_pool, k_scale, v_scale):
    """Validate the launch operands; returns (quant, hk, d, nb, bs).
    q bf16 or f32; pools int8 (with bf16 scales), bf16, or f32 (f32
    queries only); D <= 256; any block size."""
    h, d = q.shape[2], q.shape[3]
    nb, bs, hk = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    quant = k_scale is not None
    dev = q.device
    if not q.is_cuda or q.dtype not in (torch.bfloat16, torch.float32) \
            or not q.is_contiguous():
        raise ValueError("q: expected a contiguous bf16 or f32 CUDA tensor")
    kv_ok = (torch.int8,) if quant else (
        (torch.bfloat16, torch.float32) if q.dtype == torch.float32
        else (torch.bfloat16,))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != dev or t.dtype not in kv_ok \
                or t.dtype != k_pool.dtype or not t.is_contiguous() \
                or tuple(t.shape) != (nb, bs, hk, d):
            raise ValueError(f"{name}: expected contiguous {kv_ok} "
                             f"{(nb, bs, hk, d)} on {dev}")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.device != dev or t.dtype != torch.bfloat16 \
                    or not t.is_contiguous() \
                    or tuple(t.shape) != (nb, bs, hk):
                raise ValueError(f"{name}: expected contiguous bf16 "
                                 f"{(nb, bs, hk)} on {dev}")
    if h % hk or d > 256 or q.shape[0] > 65535:
        raise ValueError(f"unsupported shape: B={q.shape[0]} H={h} Hk={hk} "
                         f"D={d}")
    return quant, hk, d, nb, bs


@functools.lru_cache(maxsize=None)
def _qscale(d: int) -> float:
    return float(torch.tensor(d ** -0.5, dtype=torch.float32))


def _run(what, q, k_pool, v_pool, tbl, vlen, qoff, *, causal, k_scale=None,
         v_scale=None, seg=None, lblk=None, sel=None, out=None, o=None,
         m=None, l=None):
    """One call of ``paged_attention_run`` (the walk and the merge) with
    its f32 scratch; every operand already validated and on the card."""
    b, sq, h, d = q.shape
    nb, bs, hk = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    nslots, nblk = tbl.shape
    e, r = _split(nblk, bs)
    rows = b * h * sq
    dev = q.device
    # one f32 scratch: pacc (rows, R, D), then pm and pl (rows, R)
    scratch = torch.empty(rows * r * (d + 2), device=dev,
                          dtype=torch.float32)
    pacc, pm, pl = scratch.split([rows * r * d, rows * r, rows * r])
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = _lib()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale),
        ptr(v_scale), tbl.data_ptr(), ptr(seg), vlen.data_ptr(),
        qoff.data_ptr(), ptr(lblk), ptr(sel), ptr(out), ptr(o), ptr(m),
        ptr(l), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), b, sq, h, hk,
        d, nb, bs, nslots, nblk, e, r, int(causal),
        int(q.dtype == torch.float32), _KV_TYPES[k_pool.dtype], _qscale(d),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)


def paged_attention_launch(q, k_pool, v_pool, block_tables, kv_valid_len,
                           *, q_offset=None, k_scale=None, v_scale=None,
                           causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernels (CUDA tensors only)."""
    b = q.shape[0]
    quant, *_ = _check_launch(q, k_pool, v_pool, k_scale, v_scale)
    dev = q.device
    tbl = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    if tbl.ndim != 2 or tbl.shape[0] != b:
        raise ValueError(f"block_tables: expected ({b}, nblk), got "
                         f"{tuple(tbl.shape)}")
    out = torch.empty_like(q)
    _run("paged_attention", q, k_pool, v_pool, tbl,
         _per_slot(kv_valid_len, b, dev), _per_slot(q_offset, b, dev),
         causal=causal, k_scale=k_scale if quant else None,
         v_scale=v_scale if quant else None, out=out)
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


def paged_packed_attention_plain(q, k_pool, v_pool, block_tables, seg_ids,
                                 kv_valid_len, *, q_offset, chunk_kv: int,
                                 k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version: the paged chunk scan over the per-token table rows
    ``block_tables[clamp(seg)]`` (the reference's XLA oracle)."""
    nslots = block_tables.shape[0]
    seg = seg_ids.to(block_tables.device).long().clamp(0, nslots - 1)
    return paged_attention_plain(
        q, k_pool, v_pool, block_tables[seg], kv_valid_len,
        q_offset=q_offset, chunk_kv=chunk_kv, k_scale=k_scale,
        v_scale=v_scale, causal=True)


def paged_packed_attention_launch(q, k_pool, v_pool, block_tables, seg_ids,
                                  kv_valid_len, *, q_offset, k_scale=None,
                                  v_scale=None) -> torch.Tensor:
    """Launch the packed-query CUDA kernels (CUDA tensors only)."""
    t, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"packed queries are (T, 1, H, D), got {q.shape}")
    quant, *_ = _check_launch(q, k_pool, v_pool, k_scale, v_scale)
    dev = q.device
    tbl = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    if tbl.ndim != 2 or tbl.shape[0] < 1:
        raise ValueError(f"block_tables: expected (slots, nblk), got "
                         f"{tuple(tbl.shape)}")
    per_token = [torch.as_tensor(a, device=dev).to(torch.int32).contiguous()
                 for a in (seg_ids, kv_valid_len, q_offset)]
    for name, a in zip(("seg_ids", "kv_valid_len", "q_offset"), per_token):
        if tuple(a.shape) != (t,):
            raise ValueError(f"{name}: expected ({t},), got "
                             f"{tuple(a.shape)}")
    seg, vlen, qoff = per_token
    out = torch.empty_like(q)
    _run("paged_packed_attention", q, k_pool, v_pool, tbl, vlen, qoff,
         causal=True, k_scale=k_scale if quant else None,
         v_scale=v_scale if quant else None, seg=seg, out=out)
    return out


def paged_packed_attention(q, k_pool, v_pool, block_tables, seg_ids,
                           kv_valid_len, *, q_offset, chunk_kv: int = 1024,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Token-packed paged attention: q (T, 1, H, D) single-token queries;
    ``block_tables`` the un-gathered per-slot (slots, nblk) table;
    ``seg_ids`` (T,) each token's slot (out-of-range entries clamped,
    padding tokens masked by ``kv_valid_len == 0`` and output 0);
    ``kv_valid_len``/``q_offset`` per token (T,).  Always causal.  CUDA
    tensors launch the kernel; CPU tensors run the plain scan."""
    if q.is_cuda:
        LAUNCHES["paged_packed_attention"] += 1
        return paged_packed_attention_launch(
            q, k_pool, v_pool, block_tables, seg_ids, kv_valid_len,
            q_offset=q_offset, k_scale=k_scale, v_scale=v_scale)
    return paged_packed_attention_plain(
        q, k_pool, v_pool, block_tables, seg_ids, kv_valid_len,
        q_offset=q_offset, chunk_kv=chunk_kv, k_scale=k_scale,
        v_scale=v_scale)


def paged_attention_partials_plain(q, k_pool, v_pool, block_tables,
                                   kv_valid_len, *, q_offset=None,
                                   causal: bool, logical_blocks,
                                   entry_valid):
    """Plain version: the reference's XLA route of the block-sharded
    path — gather ``k_pool[block_tables]``, place entry e at logical
    positions ``logical_blocks[:, e] * bs + j``, AND ``entry_valid`` into
    the validity mask and take ``_local_partial`` over the whole shard.
    Returns (o (B,Hk,G,Sq,D), m, l (B,Hk,G,Sq)) f32: ``m`` the raw max
    (-1e30 where nothing is valid), ``l`` and ``o`` under max(m, -1e29).
    """
    from repro_torch.distrib.decode_attn import _local_partial
    b, sq, h, d = q.shape
    nb, bs, hk = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    dev = q.device
    tbl = block_tables.to(dev).long()
    nblk = tbl.shape[1]
    ids = tbl.clamp(0, nb - 1)
    kg = k_pool[ids].reshape(b, nblk * bs, hk, d)
    vg = v_pool[ids].reshape(b, nblk * bs, hk, d)
    kpos = (logical_blocks.to(dev).long()[:, :, None] * bs
            + torch.arange(bs, device=dev)).reshape(b, nblk * bs)
    ev = (entry_valid.to(dev) > 0).repeat_interleave(bs, dim=1)
    m, l, o = _local_partial(
        q, kg, vg, 0, kv_valid_len.to(dev),
        torch.as_tensor(q_offset, device=dev).expand(b) if causal else None,
        kpos=kpos, extra_valid=ev)
    return o, m, l


def paged_attention_partials_launch(q, k_pool, v_pool, block_tables,
                                    kv_valid_len, *, q_offset=None,
                                    causal: bool, logical_blocks,
                                    entry_valid):
    """Launch the compacted-partials CUDA kernels (CUDA tensors only)."""
    b, sq, h, d = q.shape
    _, hk, d, nb, bs = _check_launch(q, k_pool, v_pool, None, None)
    dev = q.device
    ints = [torch.as_tensor(a, device=dev).to(torch.int32).contiguous()
            for a in (block_tables, logical_blocks, entry_valid)]
    for name, a in zip(("block_tables", "logical_blocks", "entry_valid"),
                       ints):
        if a.ndim != 2 or a.shape[0] != b or a.shape != ints[0].shape:
            raise ValueError(f"{name}: expected ({b}, nblk) like "
                             f"block_tables, got {tuple(a.shape)}")
    tbl, lblk, sel = ints
    g = h // hk
    o = torch.empty((b, hk, g, sq, d), device=dev, dtype=torch.float32)
    m = torch.empty((b, hk, g, sq), device=dev, dtype=torch.float32)
    l = torch.empty_like(m)
    _run("paged_attention_partials", q, k_pool, v_pool, tbl,
         _per_slot(kv_valid_len, b, dev), _per_slot(q_offset, b, dev),
         causal=causal, lblk=lblk, sel=sel, o=o, m=m, l=l)
    return o, m, l


def paged_attention_partials(q, k_pool, v_pool, block_tables, kv_valid_len,
                             *, q_offset=None, causal: bool, logical_blocks,
                             entry_valid):
    """Un-normalized flash partials over a compacted table: entry e of
    row b covers logical block ``logical_blocks[b, e]`` of the physical
    block ``block_tables[b, e]`` (clamped) and counts only where
    ``entry_valid[b, e] > 0``.  q (B, Sq, H, D); bf16 pools (nb, bs, Hk,
    D); ``kv_valid_len`` and ``q_offset`` (B,) (``q_offset`` only read
    when ``causal``).  Returns (o, m, l) as
    ``paged_attention_partials_plain``.  CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    if q.is_cuda:
        LAUNCHES["paged_attention_partials"] += 1
        return paged_attention_partials_launch(
            q, k_pool, v_pool, block_tables, kv_valid_len,
            q_offset=q_offset, causal=causal,
            logical_blocks=logical_blocks, entry_valid=entry_valid)
    return paged_attention_partials_plain(
        q, k_pool, v_pool, block_tables, kv_valid_len, q_offset=q_offset,
        causal=causal, logical_blocks=logical_blocks,
        entry_valid=entry_valid)

"""Sequence- and block-sharded decode / mixed-chunk attention over
``torch.distributed`` (the port of the reference's
``distrib/decode_attn.py``).

A KV cache that outgrows one device is sharded across the ranks of a
process group.  Each rank attends over its own shard and the partial
results merge with the flash-attention log-sum-exp identity, in three
all-reduces of O(B * Sq * H * D) bytes, independent of context length:

    m   = max_i m_i
    l   = sum_i l_i * exp(m_i - m)
    out = sum_i o_i * l_i * exp(m_i - m) / l

Where the reference's ``shard_map`` takes global arrays and a mesh,
each rank here passes its *local* shard and a process ``group`` (None:
the default group); the rank and world size come from
``torch.distributed``, and ``pmax``/``psum`` are ``all_reduce`` with
MAX/SUM.

* ``sharded_mixed_attention``: a contiguous cache (B, S_loc, Hk, D)
  sharded on its sequence axis, rank r holding global positions
  [r*S_loc, (r+1)*S_loc); Sq >= 1 queries per slot at ``q_offset``
  (None: validity alone masks, the decode contract).  Plain torch ops,
  as the reference's XLA route.  ``sharded_decode_attention`` is its
  Sq == 1 wrapper.
* ``sharded_paged_mixed_attention``: a block-paged pool sharded on its
  block axis, rank r holding physical blocks [r*nb_loc, (r+1)*nb_loc)
  (every rank the same nb_loc); block tables replicated.  Each rank
  compacts its slice of the table (``_compact``: a stable local-first
  argsort kept to min(nblk, nb_loc) entries; a table row must not
  repeat a physical block) and turns it into partials through
  ``kernels/paged_attention.paged_attention_partials`` (``impl='auto'``:
  the Hopper kernel for CUDA tensors, the plain version for CPU
  tensors; ``'torch'``: the plain version).  The reference's
  ``chunk_kv`` has no counterpart: the kernel takes the online softmax
  per KV block and the plain version over the whole shard.
* ``sharded_packed_mixed_attention``: T single-token queries with
  per-token ``seg_ids``; gathers each token's table row and delegates.

The merge arithmetic lives in ``_lse_merge`` alone; its ``reduce``
argument is the only variable part: ``dist_reduce(group)`` all-reduces
across ranks, ``stacked_reduce`` reduces the leading axis of the
partials of n shards stacked on one device (``paged_shard_partial``
gives one shard's partials).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.kernels import paged_attention as pk
from repro_torch.nn.attention import decode_attention, mixed_attention

NEG_INF = -1e30

Reduce = Callable[[torch.Tensor, str], torch.Tensor]


def _local_partial(q, k, v, kv_base, cache_len, q_offset=None, kpos=None,
                   extra_valid=None):
    """Attention stats over one shard.

    q: (B, Sq, H, D); k/v: (B, S_loc, Hk, D); kv_base: global index of
    local position 0; cache_len: (B,) valid global length; q_offset:
    (B,) global position of each slot's query 0 (None: no causal mask).
    ``kpos`` ((S_loc,) or (B, S_loc)) overrides the keys' global
    positions and ``extra_valid`` ((B, S_loc) bool) ANDs into validity.
    Returns m, l (B, Hk, G, Sq) and o (B, Hk, G, Sq, D), f32: m the raw
    max, l and o under max(m, -1e29).
    """
    b, sq, h, d = q.shape
    s_loc, hk = k.shape[1], k.shape[2]
    dev = q.device
    qg = q.reshape(b, sq, hk, h // hk, d).float() * (d ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if kpos is None:
        kpos = kv_base + torch.arange(s_loc, device=dev)
    kpos_b = kpos[None] if kpos.ndim == 1 else kpos          # (1 or B, S_loc)
    valid = kpos_b < cache_len.to(dev)[:, None]              # (B, S_loc)
    if extra_valid is not None:
        valid = valid & extra_valid
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    if q_offset is not None:
        qpos = q_offset.to(dev)[:, None] + torch.arange(sq, device=dev)
        causal = qpos[:, :, None] >= kpos_b[:, None, :]      # (B, Sq, S_loc)
        s = torch.where(causal[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = m.clamp(min=-1e29)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m, l, o


def dist_reduce(group=None) -> Reduce:
    """``reduce`` for ``_lse_merge``: all-reduce (MAX or SUM) across the
    ranks of ``group``."""
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        t = t.contiguous()
        dist.all_reduce(t, op=ops[op], group=group)
        return t
    return reduce


def stacked_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``reduce`` for ``_lse_merge`` over the partials of n shards
    stacked on a leading axis on one device."""
    return t.amax(dim=0) if op == "max" else t.sum(dim=0)


def _lse_merge(m, l, o, out_dtype, reduce: Reduce):
    """Stitch per-shard (m, l, o) partials with the log-sum-exp identity
    (three reductions; both maxima clamped finite so a fully masked
    shard contributes exactly 0, and a row masked on every shard comes
    out 0).  ``reduce(t, op)`` may work in place on ``t``."""
    m_g = reduce(m.clone(), "max")
    corr = torch.exp(m.clamp(min=-1e29) - m_g.clamp(min=-1e29))
    l_g = reduce(l * corr, "sum")
    o_g = reduce(o * corr[..., None], "sum")
    out = o_g / l_g.clamp(min=1e-30)[..., None]
    b, hk, g, sq, d = out.shape
    return out.movedim(3, 1).reshape(b, sq, hk * g, d).to(out_dtype)


def sharded_mixed_attention(q, k_cache, v_cache, cache_len, q_offset=None,
                            *, group=None):
    """q: (B, Sq, H, D) on every rank; k/v_cache: this rank's (B, S_loc,
    Hk, D) slice of the sequence; cache_len / q_offset (B,) global.

    cache_len is the post-append valid length (the Sq new tokens' K/V
    already written at [q_offset, q_offset + n_new)); q_offset enables
    causal masking at the per-slot offset."""
    s_loc = k_cache.shape[1]
    m, l, o = _local_partial(q, k_cache, v_cache,
                             dist.get_rank(group) * s_loc, cache_len,
                             q_offset)
    return _lse_merge(m, l, o, q.dtype, dist_reduce(group))


def sharded_decode_attention(q, k_cache, v_cache, cache_len, *,
                             group=None):
    """One-token decode (Sq == 1) against a sequence-sharded cache."""
    return sharded_mixed_attention(q, k_cache, v_cache, cache_len, None,
                                   group=group)


def _compact(tbl, base: int, nb_loc: int, l_loc: int):
    """A shard's compacted table: local entries first (stable, so
    logical order is kept), cut to ``l_loc`` entries.  Returns (keep:
    the logical block of each kept entry, sel_local: whether it is
    local, g_ids: its block in the shard, clamped)."""
    is_local = (tbl >= base) & (tbl < base + nb_loc)           # (B, nblk)
    order = torch.argsort((~is_local).to(torch.int32), dim=1, stable=True)
    keep = order[:, :l_loc]                                   # (B, l_loc)
    sel_local = torch.gather(is_local, 1, keep)
    g_ids = (torch.gather(tbl, 1, keep) - base).clamp(0, nb_loc - 1)
    return keep, sel_local, g_ids


def paged_shard_partial(q, k_pool, v_pool, block_tables, cache_len, shard,
                        q_offset=None, *, impl: str = "auto"):
    """One shard's (m, l, o) partials: ``k_pool``/``v_pool`` its (nb_loc,
    bs, Hk, D) slice, physical blocks [shard*nb_loc, (shard+1)*nb_loc)
    of the global pool; ``block_tables`` (B, nblk) global."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"impl {impl!r}: expected 'auto' or 'torch'")
    nb_loc = k_pool.shape[0]
    tbl = block_tables.to(q.device).long()
    keep, sel, g_ids = _compact(tbl, shard * nb_loc, nb_loc,
                                min(tbl.shape[1], nb_loc))
    fn = pk.paged_attention_partials if impl == "auto" \
        else pk.paged_attention_partials_plain
    o, m, l = fn(q, k_pool, v_pool, g_ids, cache_len, q_offset=q_offset,
                 causal=q_offset is not None, logical_blocks=keep,
                 entry_valid=sel)
    return m, l, o


def sharded_paged_mixed_attention(q, k_pool, v_pool, block_tables,
                                  cache_len, q_offset=None, *, group=None,
                                  impl: str = "auto"):
    """Mixed-chunk attention against a block-paged pool sharded on its
    block axis.

    q: (B, Sq, H, D) on every rank; k_pool/v_pool: this rank's (nb_loc,
    block_size, Hk, D) slice; block_tables: (B, nblk) global physical
    block of each logical block (out-of-range values for unassigned
    entries); cache_len: (B,) post-append valid logical lengths;
    q_offset: (B,) position of each slot's query 0 (None: validity-only
    masking, the decode contract)."""
    m, l, o = paged_shard_partial(q, k_pool, v_pool, block_tables,
                                  cache_len, dist.get_rank(group),
                                  q_offset, impl=impl)
    return _lse_merge(m, l, o, q.dtype, dist_reduce(group))


def sharded_packed_mixed_attention(q, k_pool, v_pool, block_tables, seg_ids,
                                   kv_valid_len, q_offset=None, *,
                                   group=None, impl: str = "auto"):
    """Token-packed variant: q (T, 1, H, D) with per-token ``seg_ids``
    into the (slots, nblk) table and per-token ``kv_valid_len`` /
    ``q_offset``; bucket-padding tokens (seg -1) clamp to slot 0 and are
    masked by their zero validity length (output 0)."""
    nslots = block_tables.shape[0]
    seg = seg_ids.to(block_tables.device).long().clamp(0, nslots - 1)
    return sharded_paged_mixed_attention(
        q, k_pool, v_pool, block_tables[seg], kv_valid_len, q_offset,
        group=group, impl=impl)


def reference_decode_attention(q, k_cache, v_cache, cache_len):
    """Unsharded oracle of ``sharded_decode_attention``."""
    return decode_attention(q, k_cache, v_cache, cache_len)


def reference_mixed_attention(q, k_cache, v_cache, cache_len, q_offset):
    """Unsharded oracle of ``sharded_mixed_attention``."""
    return mixed_attention(q, k_cache, v_cache, cache_len, q_offset,
                           chunk_kv=k_cache.shape[1])


def reference_paged_mixed_attention(q, k_pool, v_pool, block_tables,
                                    cache_len, q_offset):
    """Unsharded oracle of ``sharded_paged_mixed_attention``."""
    nblk = block_tables.shape[1]
    return mixed_attention(q, k_pool, v_pool, cache_len, q_offset,
                           chunk_kv=nblk * k_pool.shape[1],
                           block_tables=block_tables)

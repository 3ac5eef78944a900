"""Serving engine: ternarized weights, token-budget continuous batching.

The port of the reference engine's core (``repro/serve/engine.py``):

  * ``ternarize_model`` converts master weights into TiM serving codes
    (int8, or 2-bit packed);
  * ``ServeEngine`` is the chunked-prefill continuous-batching scheduler
    around ONE unified mixed prefill/decode step over a block-paged KV
    pool (serve/block_pool).  Every iteration schedules one token per
    decoding slot first, then prompt slices under the ``token_budget``,
    into a padded (``batch_slots``, ``chunk``) grid.  The step runs that
    grid (``make_paged_unified_step``) or, with ``packed=True``, the
    grid's scheduled tokens flattened into a (T, 1) buffer bucketed to a
    power of two (``make_packed_unified_step``, ``_flatten_grid``);
  * cross-request prefix reuse: admission chain-hashes the prompt's full
    blocks and re-references resident ones; a partially matching tail
    block (a live slot's or one a finished request donated) is copied
    (``copy_kv_block``) before the newcomer writes into it;
  * preemption/swap: a pool below the full-batch floor (but at least
    one full sequence plus a spare block) preempts the youngest
    prefilling slot when allocation fails; the victim's exclusively
    owned blocks are swapped to host memory (``fetch_kv_blocks``, one
    batched copy) or dropped for recompute, whichever the roofline
    crossover prices cheaper, and the request resumes from the queue
    front with its effective prompt;
  * greedy decoding; ``stats()`` exposes the counters.

Not ported yet (constructor or ``submit`` raises NotImplementedError):
speculative decoding, sampling, ``n > 1`` siblings, beam search and
guided masks.

Host/device hand-off: all scheduler state is host numpy.  Each step
hands the model private CPU copies of every scheduler array (tokens,
cache_len, n_new, block tables, slot map), so later in-place host
updates can never reach what a step reads, however the copy to the
device is ordered.  The only device-to-host transfer per step is the
fetch of the greedy tokens (``d2h_fetches``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.ternary import TernaryScales
from repro_torch.core.weights import TernaryWeight
from repro_torch.models import transformer as tfm
from repro_torch.nn.linear import ternarize_dense_params
from repro_torch.serve.block_pool import (ROOT_HASH, BlockPool, chain_hash,
                                          default_num_blocks)

_TERNARY_LAYER_KEYS = {"q", "k", "v", "o", "gate", "up", "down"}
_KV_KEYS = ("k", "v", "k_scale", "v_scale")

# Swap-vs-recompute crossover defaults: the H100 SXM's published peaks
# (NVIDIA data sheet) — 989 TFLOP/s bf16 dense for replaying dropped
# tokens, and PCIe Gen5 x16, 64 GB/s per direction, for the host link a
# swap crosses twice.
H100_BF16_FLOPS = 989e12
H100_HOST_LINK_BW = 64e9


# ---------------------------------------------------------------------------
# weight conversion (fp master -> TiM codes)
# ---------------------------------------------------------------------------

def tree_to(tree, device):
    """Move every tensor of a params tree (TernaryWeights included)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, TernaryWeight):
        return dataclasses.replace(tree, data=tree.data.to(device),
                                   scales=tree_to(tree.scales, device))
    if isinstance(tree, TernaryScales):
        return TernaryScales(tree.pos.to(device), tree.neg.to(device),
                             tree.sym)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree


def ternarize_model(params: Dict[str, Any], cfg: ArchConfig,
                    device="cuda") -> Dict[str, Any]:
    """Convert every ternary projection (q/k/v/o, gate/up/down) into
    serving codes with per-output-column scales, and place the tree on
    ``device``.  Statistics are taken on the bf16 view of the master."""
    dev = resolve_device(device)
    pol = cfg.ternary

    def convert(tree, path=()):
        if isinstance(tree, dict):
            if pol.enabled and isinstance(tree.get("w"), torch.Tensor) \
                    and tree["w"].ndim >= 2 and path \
                    and path[-1] in _TERNARY_LAYER_KEYS:
                return ternarize_dense_params(tree_to(tree, dev), pol)
            return {k: convert(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [convert(v, path) for v in tree]
        return tree_to(tree, dev)

    return convert(params)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_paged_unified_step(cfg: ArchConfig, impl: Optional[str] = None):
    """THE engine step: the unified mixed prefill/decode step against a
    block-paged KV pool.  Returns (per-slot logits at each slot's last
    valid token (slots, vocab), caches)."""
    def paged_step(params, batch, caches, cache_len, n_new, block_tables,
                   slot_map):
        hidden, caches, _ = tfm.forward(
            params, cfg, batch, mode="mixed", caches=caches,
            cache_len=cache_len, n_new=n_new, block_tables=block_tables,
            slot_map=slot_map, impl=impl)
        dev = hidden.device
        last_idx = (n_new.to(dev).long() - 1).clamp(min=0)
        last = hidden[torch.arange(hidden.shape[0], device=dev), last_idx]
        lg = tfm.logits(params, cfg, last[:, None])
        return lg[:, 0], caches
    return paged_step


def make_packed_unified_step(cfg: ArchConfig, impl: Optional[str] = None):
    """The token-packed engine step: the unified step over a flat (T, 1)
    buffer.  ``positions``/``n_new`` are per token (write offset, 1 or
    0), ``seg_ids`` (T,) each token's slot, ``slot_map`` (T, 1) its
    physical write position and ``last_idx`` (slots,) the flat index of
    each slot's last scheduled token; the gather ``hidden[last_idx]``
    keeps the logits at (slots, vocab), as the padded step returns
    them (rows of unscheduled slots point at 0 and are ignored)."""
    def packed_step(params, batch, caches, positions, n_new, seg_ids,
                    block_tables, slot_map, last_idx):
        hidden, caches, _ = tfm.forward(
            params, cfg, batch, mode="mixed", caches=caches,
            cache_len=positions, n_new=n_new, block_tables=block_tables,
            slot_map=slot_map, impl=impl, seg_ids=seg_ids)
        last = hidden[last_idx.to(hidden.device).long()]   # (slots, 1, d)
        lg = tfm.logits(params, cfg, last)
        return lg[:, 0], caches
    return packed_step


def copy_kv_block(caches, src: int, dst: int):
    """Copy one physical KV block (every layer; K, V and any scales) in
    place — the copy-on-write primitive of partial-tail prefix sharing."""
    for layer in caches:
        for key in _KV_KEYS:
            if key in layer:
                layer[key][dst] = layer[key][src]
    return caches


def fetch_kv_blocks(caches, bids) -> Dict[str, torch.Tensor]:
    """Device -> host copy of physical KV blocks ``bids`` (every layer;
    K, V and any scales): the swap-out half of preemption.  Returns
    {key: (layers, len(bids), block_size, ...) CPU tensor}, all carved
    from ONE synchronous device-to-host copy into pageable memory."""
    dev = caches[0]["k"].device
    idx = torch.as_tensor(np.asarray(bids, np.int64), device=dev)
    keys = [k for k in _KV_KEYS if k in caches[0]]
    parts = [torch.stack([layer[k].index_select(0, idx) for layer in caches])
             for k in keys]
    host = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts]).cpu()
    out, off = {}, 0
    for k, p in zip(keys, parts):
        n = p.numel() * p.element_size()
        out[k] = host[off:off + n].view(p.dtype).reshape(p.shape)
        off += n
    return out


def write_kv_block(caches, dst: int, values: Dict[str, torch.Tensor]):
    """Host -> device restore of ONE physical block from a
    ``fetch_kv_blocks``-shaped tree sliced to that block ({key: (layers,
    block_size, ...)}): the swap-in half, written in place."""
    for key, v in values.items():
        dv = v.to(caches[0][key].device)
        for layer, row in zip(caches, dv):
            layer[key][dst] = row
    return caches


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# token-budget continuous-batching scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (len,) int32
    max_new_tokens: int
    media: Optional[np.ndarray] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefix_hit_tokens: int = 0   # prompt tokens served from shared blocks
    truncated: bool = False      # cache filled before max_new_tokens
    submit_step: int = -1
    token_steps: List[int] = dataclasses.field(default_factory=list)
    # not ported yet; submit() rejects anything but the defaults
    n: int = 1
    sample_mode: str = "independent"
    allowed_tokens: Optional[Callable[[List[int]], Optional[Sequence[int]]]] \
        = None


def _count_params(tree) -> int:
    """Elements of every tensor in a params tree (a TernaryWeight counts
    its codes and both scale vectors), as the reference counts leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, TernaryWeight):
        return (tree.data.numel() + _count_params(tree.scales.pos)
                + _count_params(tree.scales.neg))
    if isinstance(tree, dict):
        return sum(_count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_params(v) for v in tree)
    return 0


def _host(a: np.ndarray) -> torch.Tensor:
    """A private CPU tensor copy of a scheduler array (never aliases)."""
    return torch.from_numpy(np.array(a, copy=True))


class ServeEngine:
    """Chunked-prefill continuous batching over a block-paged KV pool.

    One unified step serves prefill and decode; ``token_budget`` bounds
    the real tokens per iteration (decodes first).  ``packed=False`` runs
    the padded (``batch_slots``, ``chunk``) grid, ``packed=True`` its
    scheduled tokens as one flat bucketed buffer (the same tokens, fewer
    grid rows).  The KV cache is a global pool of ``num_blocks`` x
    ``block_size`` blocks addressed through per-slot block tables; with
    ``prefix_reuse`` admission re-references resident prompt blocks and
    copies a matching partial tail block before writing.

    Pool sizing: at least ``ceil(max_len / block_size) + 1`` blocks (one
    full sequence plus a spare; below it ``ValueError``).  Below the
    full-batch floor ``batch_slots * ceil(max_len / block_size) + 1`` the
    engine preempts under ``preempt``: 'swap' (victim's blocks to host
    memory), 'recompute' (dropped and replayed), 'auto' (whichever the
    crossover prices cheaper: 2 * n_params FLOPs per replayed token at
    ``peak_flops`` against a round trip of the blocks' bytes at
    ``host_link_bw``; H100 defaults) or 'none' (never; an undersized pool
    can then livelock, and ``run_until_done`` raises).  ``device``
    defaults to CUDA (raises without it).
    """

    def __init__(self, params, cfg: ArchConfig, batch_slots: int,
                 max_len: int, greedy: bool = True, chunk: int = 16,
                 token_budget: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefix_reuse: bool = True,
                 preempt: str = "auto", packed: bool = False,
                 spec_k: int = 0, peak_flops: float = H100_BF16_FLOPS,
                 host_link_bw: float = H100_HOST_LINK_BW, device="cuda"):
        if chunk < 1:
            raise ValueError(f"chunk {chunk} < 1")
        if preempt not in ("auto", "swap", "recompute", "none"):
            raise ValueError(f"preempt {preempt!r}: expected 'auto', "
                             f"'swap', 'recompute' or 'none'")
        for flag, what in ((spec_k, "spec_k > 0 (speculative decoding)"),
                           (not greedy, "greedy=False (sampling)")):
            if flag:
                raise NotImplementedError(f"{what} is not ported yet")
        tfm._check_dense(cfg)
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, engine "
                             f"device is {self.device}")
        self.params = params
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.chunk = min(chunk, max_len)
        self.token_budget = (batch_slots + self.chunk
                             if token_budget is None else token_budget)
        if self.token_budget < 1:
            raise ValueError(f"token_budget {token_budget} < 1")
        self.block_size = max(1, block_size)
        self.max_blocks = -(-max_len // self.block_size)
        if num_blocks is None:
            num_blocks = default_num_blocks(batch_slots, max_len,
                                            self.block_size)
        if num_blocks < self.max_blocks + 1:
            raise ValueError(
                f"num_blocks {num_blocks} < ceil(max_len / block_size) + 1 "
                f"= {self.max_blocks + 1}: the pool must hold one full "
                f"sequence plus a spare block, or even a lone request "
                f"cannot complete")
        self.preemptable = num_blocks < batch_slots * self.max_blocks + 1
        self.preempt = preempt
        self.packed = bool(packed)
        self.peak_flops = float(peak_flops)
        self.host_link_bw = float(host_link_bw)
        if cfg.attn_chunk_kv % self.block_size:
            raise ValueError(
                f"block_size {self.block_size} must divide attn_chunk_kv "
                f"{cfg.attn_chunk_kv}: paged attention chunks the scan in "
                f"whole blocks")
        self.prefix_reuse = prefix_reuse
        self.pool = BlockPool(num_blocks, self.block_size)
        self.caches = tfm.init_paged_caches(cfg, batch_slots, num_blocks,
                                            self.block_size, self.device)
        self.cache_len = np.zeros((batch_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_prompt: List[Optional[np.ndarray]] = [None] * batch_slots
        self.slot_fill = np.zeros((batch_slots,), np.int64)
        self.block_tables = np.full((batch_slots, self.max_blocks), -1,
                                    np.int32)
        self.slot_nblocks = np.zeros((batch_slots,), np.int64)
        self.slot_hist: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_chain: List[List[bytes]] = [[] for _ in range(batch_slots)]
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.iters = 0
        self.truncated_requests = 0
        self.d2h_fetches = 0
        self.prefix_hit_tokens = 0
        self.scheduled_prefill_tokens = 0
        self.scheduled_tokens = 0
        self.grid_tokens = 0
        self.admitted_prompt_tokens = 0
        self.cow_copies = 0
        self._tail_cache: Dict[int, Tuple[tuple, tuple]] = {}
        self._last_slot_map: Optional[np.ndarray] = None
        # preemption/swap: admission order (victims are the youngest),
        # the host swap arena (uid -> resume prompt + saved blocks) and
        # the per-slot flag that stops a resumed decode's refill from
        # re-appending its pending token
        self._admit_seq = 0
        self.slot_seq = np.zeros((batch_slots,), np.int64)
        self._resume: Dict[int, Dict[str, Any]] = {}
        self._skip_sample = np.zeros((batch_slots,), bool)
        self.preemptions = 0
        self.swapped_out_blocks = 0
        self.swapped_in_blocks = 0
        self.swapped_in_tokens = 0
        self.recompute_tokens = 0
        self.swap_d2h_fetches = 0
        self.swap_d2h_bytes = 0          # host-side size of the arena
        self.swap_d2h_seconds = 0.0      # wall time of the swap-out copies
        # crossover inputs, counted as the reference counts them: every
        # tensor of the params tree, and the KV bytes of one block
        self._n_params = _count_params(params)
        self._block_bytes = sum(
            t.numel() * t.element_size() for layer in self.caches
            for t in layer.values()) / max(num_blocks, 1)
        self._step = (make_packed_unified_step(cfg) if self.packed
                      else make_paged_unified_step(cfg))

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request):
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if plen > self.max_len:
            raise ValueError(
                f"prompt of {plen} tokens exceeds the engine's cache "
                f"capacity max_len={self.max_len}")
        if req.n != 1 or req.sample_mode != "independent":
            raise NotImplementedError(
                "n > 1 siblings and beam search are not ported yet")
        if req.allowed_tokens is not None or req.media is not None:
            raise NotImplementedError(
                "guided masks and media are not ported yet")
        req.submit_step = self.iters
        self.queue.append(req)

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    # -- prefix matching ----------------------------------------------------

    def _match_full_blocks(self, tokens: np.ndarray):
        """Chain-hash the prompt's full blocks against the pool; returns
        (matched_tokens, hit_bids, chain), every hit's refcount bumped."""
        bs = self.block_size
        hits: List[int] = []
        chain: List[bytes] = []
        prev = ROOT_HASH
        matched = 0
        for jb in range(len(tokens) // bs):
            h = chain_hash(prev, tokens[jb * bs:(jb + 1) * bs])
            bid = self.pool.lookup(h)
            if bid is None:
                break
            hits.append(bid)
            chain.append(h)
            prev = h
            matched += bs
        return matched, hits, chain

    def _match_partial_tail(self, chain: List[bytes], tokens: np.ndarray,
                            matched: int):
        """Extend a full-block match into a partially filled tail block
        (a live slot's tail, or one a finished request donated).  Returns
        (src_bid, n_tokens, donated); a donated winner has been revived
        (a transient reference the caller drops after the copy)."""
        bs = self.block_size
        jb = matched // bs
        limit = len(tokens) - 1 - matched   # last token must be computed
        if limit <= 0:
            return -1, 0, False

        def overlap(tail):
            n = 0
            for a, b in zip(tokens[matched:matched + limit], tail):
                if int(a) != int(b):
                    break
                n += 1
            return n

        best_bid, best_l, best_donated = -1, 0, False
        for s in self._active_slots():
            f = len(self.slot_hist[s])
            if f // bs != jb or f % bs == 0:
                continue
            if self.slot_chain[s] != chain:
                continue
            n = overlap(self.slot_hist[s][jb * bs:f])
            if n > best_l:
                best_bid, best_l = int(self.block_tables[s, jb]), n
                best_donated = False
        for bid, (tchain, tail) in self._tail_cache.items():
            if tchain != tuple(chain):
                continue
            n = overlap(tail)
            if n > best_l:
                best_bid, best_l, best_donated = bid, n, True
        if best_donated and not self.pool.revive(best_bid):
            self._tail_cache.pop(best_bid, None)
            return -1, 0, False
        return best_bid, best_l, best_donated

    def _donate_tail(self, i: int):
        """Record a finishing slot's partial tail block as a copy-on-write
        donor (metadata only: no pool reference is held)."""
        cl = int(self.cache_len[i])
        if cl % self.block_size == 0:
            return
        bid = int(self.block_tables[i, cl // self.block_size])
        self._tail_cache.pop(bid, None)
        while len(self._tail_cache) >= max(2 * self.slots, 2):
            del self._tail_cache[next(iter(self._tail_cache))]
        start = (cl // self.block_size) * self.block_size
        self._tail_cache[bid] = (tuple(self.slot_chain[i]),
                                 tuple(self.slot_hist[i][start:cl]))

    def _alloc_block(self) -> Optional[int]:
        """``pool.try_allocate`` (None when the pool is exhausted); a
        recycled block's tail donation dies with the allocation."""
        bid = self.pool.try_allocate()
        if bid is not None:
            self._tail_cache.pop(bid, None)
        return bid

    def _cow_block(self, slot: int, jb: int, src: int) -> int:
        """Copy-on-write: deep-copy block ``src`` into a fresh block at
        this slot's table entry ``jb``, before the slot's first write.
        Returns -1 (no copy; the tokens are recomputed) when the pool has
        no block to spare — admission never preempts for this."""
        dst = self._alloc_block()
        if dst is None:
            return -1
        self.caches = copy_kv_block(self.caches, src, dst)
        self.cow_copies += 1
        self.block_tables[slot, jb] = dst
        self.slot_nblocks[slot] = jb + 1
        return dst

    def _admit(self):
        """Assign queued requests to free slots: prefix matching jumps the
        prompt cursor over resident blocks; a partial-tail hit costs one
        block copy.  No forward pass happens here.

        A preempted request re-enters from the queue front with its
        effective prompt (prompt + tokens generated before preemption):
        hash matching re-attaches still-resident shared blocks, swapped
        blocks upload from the host arena (bit-identical), and the rest
        is recomputed.  The admission gate (one allocatable block while
        other slots are active) keeps admission from thrashing straight
        back into preemption."""
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            if self.pool.blocks_free < 1 and self._active_slots():
                break
            req = self.queue.pop(0)
            res = self._resume.pop(req.uid, None)
            tokens_in = np.asarray(req.prompt if res is None
                                   else res["prompt"], np.int32)
            plen = len(tokens_in)
            resumed_dec = bool(res and res["decoding"])
            self.admitted_prompt_tokens += plen

            matched, hits, chain = (
                self._match_full_blocks(tokens_in) if self.prefix_reuse
                else (0, [], []))
            cow_src, cow_take, cow_release = -1, 0, -1
            if matched >= plen and resumed_dec:
                # a resumed decode needs no logits from its refill: full
                # coverage goes straight back to decoding
                matched = plen
            elif matched >= plen:
                # whole-prompt hit: re-own the last block so its final
                # position can be recomputed for logits
                cow_src = hits.pop()
                chain.pop()
                matched -= self.block_size
                cow_take, cow_release = self.block_size - 1, cow_src
            elif self.prefix_reuse and res is None:
                cow_src, cow_take, donated = self._match_partial_tail(
                    chain, tokens_in, matched)
                if donated:
                    cow_release = cow_src

            self.slot_req[slot] = req
            self.slot_prompt[slot] = tokens_in
            self.block_tables[slot].fill(-1)
            for jb, bid in enumerate(hits):
                self.block_tables[slot, jb] = bid
            self.slot_nblocks[slot] = len(hits)
            self.slot_chain[slot] = list(chain)
            if cow_src >= 0 and cow_take > 0 and \
                    self._cow_block(slot, len(hits), cow_src) >= 0:
                matched += cow_take
            if cow_release >= 0:
                self.pool.decref(cow_release)
            req.prefix_hit_tokens = matched
            self.prefix_hit_tokens += matched
            if res is not None:
                matched = self._swap_in(slot, res, tokens_in, matched,
                                        plen if resumed_dec else plen - 1)
                self.recompute_tokens += max(0, res["covered"] - matched)
            self.slot_hist[slot] = [int(t) for t in tokens_in[:matched]]
            self.slot_fill[slot] = matched
            self.cache_len[slot] = matched
            self.slot_seq[slot] = self._admit_seq
            self._admit_seq += 1
            self._skip_sample[slot] = resumed_dec and matched < plen

    def _swap_in(self, slot: int, res: Dict[str, Any],
                 tokens_in: np.ndarray, matched: int, cap: int) -> int:
        """Upload a resumed request's swapped blocks from the host arena
        into fresh pool blocks, extending the hash-matched prefix
        contiguously; full restored blocks are re-registered under their
        chain hashes.  Returns the new matched length."""
        bs = self.block_size
        covered = int(res["covered"])
        swap = res["swap"]
        jb = int(self.slot_nblocks[slot])
        while jb in swap and matched == jb * bs:
            take = min(covered, (jb + 1) * bs) - jb * bs
            if take <= 0 or matched + take > cap:
                break
            bid = self._alloc_block()
            if bid is None:
                break                 # recompute the rest instead
            self.caches = write_kv_block(self.caches, bid, swap.pop(jb))
            self.block_tables[slot, jb] = bid
            self.slot_nblocks[slot] = jb + 1
            if take == bs and self.prefix_reuse:
                prev = self.slot_chain[slot][-1] if self.slot_chain[slot] \
                    else ROOT_HASH
                h = chain_hash(prev, tokens_in[jb * bs:(jb + 1) * bs])
                self.slot_chain[slot].append(h)
                self.pool.register(bid, h)
            matched += take
            self.swapped_in_blocks += 1
            self.swapped_in_tokens += take
            jb += 1
        return matched

    # -- preemption / swap --------------------------------------------------

    def _pick_victim(self, requester: int,
                     allow_decode: bool) -> Optional[int]:
        """The youngest prefilling slot (least sunk work).  A decode
        requester falls back to the youngest other slot and, last, to
        itself; a prefill requester only preempts younger prefills (it
        otherwise takes a smaller chunk)."""
        def youngest(cands):
            return max(cands, key=lambda s: self.slot_seq[s], default=None)
        active = self._active_slots()
        prefilling = [s for s in active if s != requester
                      and self.slot_fill[s] < len(self.slot_prompt[s])]
        if not allow_decode:
            prefilling = [s for s in prefilling
                          if self.slot_seq[s] > self.slot_seq[requester]]
        v = youngest(prefilling)
        if v is not None or not allow_decode:
            return v
        v = youngest([s for s in active if s != requester])
        if v is not None:
            return v
        return requester if requester in active else None

    def _swap_or_recompute(self, covered: int, n_own: int) -> str:
        """'swap' when a host round trip of the owned blocks costs less
        than replaying their tokens (the roofline crossover)."""
        if self.preempt != "auto":
            return self.preempt
        own_tokens = min(covered, n_own * self.block_size)
        t_recompute = 2.0 * self._n_params * own_tokens / self.peak_flops
        t_swap = 2.0 * n_own * self._block_bytes / self.host_link_bw
        return "swap" if t_swap < t_recompute else "recompute"

    def _preempt(self, victim: int):
        """Evict a running slot: swap its exclusively owned blocks to the
        host arena (or drop them for recompute), release every block
        reference and requeue the request at the queue front with its
        effective prompt, so it resumes exactly where it stopped.
        Shared blocks stay resident and re-attach by chain hash."""
        req = self.slot_req[victim]
        covered = int(self.cache_len[victim])
        # a prefilling victim keeps its prompt; a decoding one resumes
        # from the cache contents, out_tokens[-1] the pending input
        if self.slot_fill[victim] < len(self.slot_prompt[victim]):
            eff = np.asarray(self.slot_prompt[victim], np.int32)
        else:
            eff = np.asarray(self.slot_hist[victim], np.int32)
        own = [(jb, int(self.block_tables[victim, jb]))
               for jb in range(int(self.slot_nblocks[victim]))
               if self.pool.refcount[int(self.block_tables[victim, jb])]
               == 1]
        swap: Dict[int, Dict[str, torch.Tensor]] = {}
        if own and self._swap_or_recompute(covered, len(own)) == "swap":
            t0 = time.perf_counter()
            fetched = fetch_kv_blocks(self.caches, [b for _, b in own])
            self.swap_d2h_seconds += time.perf_counter() - t0
            self.swap_d2h_bytes += sum(t.numel() * t.element_size()
                                       for t in fetched.values())
            self.swap_d2h_fetches += 1
            for pos, (jb, _) in enumerate(own):
                swap[jb] = {k: t[:, pos] for k, t in fetched.items()}
            self.swapped_out_blocks += len(own)
        self._resume[req.uid] = {"prompt": eff,
                                 "decoding": bool(req.out_tokens),
                                 "covered": covered, "swap": swap}
        # the never-scheduled prompt remainder leaves the admitted count
        # (re-admission counts the resume prompt in full), keeping
        # scheduled_prefill + prefix_hit + swapped_in == admitted exact
        self.admitted_prompt_tokens -= max(
            0, len(self.slot_prompt[victim]) - int(self.slot_fill[victim]))
        self.preemptions += 1
        self.slot_req[victim] = None
        self.slot_prompt[victim] = None
        self.slot_fill[victim] = 0
        self.cache_len[victim] = 0
        self._skip_sample[victim] = False
        self._release_slot(victim)
        self.queue.insert(0, req)

    def _ensure_blocks(self, i: int, upto_len: int,
                       allow_decode_victims: bool = True,
                       on_preempt: Optional[Callable[[int], None]] = None
                       ) -> bool:
        """Allocate blocks so slot i holds ``upto_len`` positions,
        preempting other slots when the pool is exhausted.  False when
        slot i cannot be fully grown (it preempted itself, or a prefill
        requester found no eligible victim)."""
        need = -(-upto_len // self.block_size)
        while self.slot_nblocks[i] < need:
            bid = self._alloc_block()
            if bid is None:
                if self.preempt == "none":
                    return False
                victim = self._pick_victim(i, allow_decode_victims)
                if victim is None:
                    return False
                self._preempt(victim)
                if on_preempt is not None:
                    on_preempt(victim)
                if victim == i:
                    return False
                continue
            self.block_tables[i, self.slot_nblocks[i]] = bid
            self.slot_nblocks[i] += 1
        return True

    def _schedule(self):
        """Fill the (slots, chunk) grid: decodes first, then prompt
        slices under the remaining budget; build the physical write map
        (slot_map) and allocate the blocks the tokens land in.  On an
        undersized pool an allocation failure preempts a victim, and a
        victim already scheduled this iteration is unscheduled (its rows
        cleared, its budget refunded) before the step runs."""
        tokens = np.zeros((self.slots, self.chunk), np.int32)
        n_new = np.zeros((self.slots,), np.int32)
        oob = self.pool.num_blocks * self.block_size
        slot_map = np.full((self.slots, self.chunk), oob, np.int32)
        decode_slots: List[int] = []
        finishing_prefill: List[int] = []
        budget = self.token_budget

        def unschedule(v):
            nonlocal budget
            budget += int(n_new[v])
            tokens[v] = 0
            n_new[v] = 0
            slot_map[v] = oob
            if v in decode_slots:
                decode_slots.remove(v)
            if v in finishing_prefill:
                finishing_prefill.remove(v)

        def write_map(i, t):
            pos = int(self.cache_len[i]) + np.arange(t)
            blk = self.block_tables[i, pos // self.block_size]
            slot_map[i, :t] = blk * self.block_size + pos % self.block_size

        for i in self._active_slots():
            if self.slot_req[i] is None:
                continue            # preempted earlier in this pass
            if self.slot_fill[i] >= len(self.slot_prompt[i]):
                if not self._ensure_blocks(i, int(self.cache_len[i]) + 1,
                                           on_preempt=unschedule):
                    continue        # last-resort self-preemption
                tokens[i, 0] = self.slot_req[i].out_tokens[-1]
                n_new[i] = 1
                write_map(i, 1)
                decode_slots.append(i)
                budget -= 1   # decode is never stalled, even if < 0
        for i in self._active_slots():
            if self.slot_req[i] is None:
                continue
            plen = len(self.slot_prompt[i])
            fill = int(self.slot_fill[i])
            if fill >= plen or budget <= 0:
                continue
            take = min(self.chunk, plen - fill, budget)
            cl = int(self.cache_len[i])
            if not self._ensure_blocks(i, cl + take,
                                       allow_decode_victims=False,
                                       on_preempt=unschedule):
                # shrink the chunk to the blocks this slot already owns
                take = min(take,
                           int(self.slot_nblocks[i]) * self.block_size - cl)
                if take <= 0:
                    continue
            tokens[i, :take] = self.slot_prompt[i][fill:fill + take]
            n_new[i] = take
            write_map(i, take)
            budget -= take
            if fill + take >= plen:
                finishing_prefill.append(i)
        return tokens, n_new, slot_map, decode_slots, finishing_prefill

    def _release_slot(self, i: int):
        for jb in range(int(self.slot_nblocks[i])):
            self.pool.decref(int(self.block_tables[i, jb]))
        self.block_tables[i].fill(-1)
        self.slot_nblocks[i] = 0
        self.slot_hist[i] = []
        self.slot_chain[i] = []

    def _finish_check(self, i: int):
        req = self.slot_req[i]
        if len(req.out_tokens) >= req.max_new_tokens or \
                int(self.cache_len[i]) >= self.max_len:
            if len(req.out_tokens) < req.max_new_tokens:
                req.truncated = True
                self.truncated_requests += 1
            req.done = True
            self.finished.append(req)
            self.slot_req[i] = None
            self.slot_prompt[i] = None
            if self.prefix_reuse:
                self._donate_tail(i)
            self._release_slot(i)

    def _register_completed(self, i: int, old_len: int, new_len: int):
        """Publish the chain hash of every block slot i completed."""
        bs = self.block_size
        for jb in range(old_len // bs, new_len // bs):
            prev = self.slot_chain[i][-1] if self.slot_chain[i] \
                else ROOT_HASH
            h = chain_hash(prev, self.slot_hist[i][jb * bs:(jb + 1) * bs])
            self.slot_chain[i].append(h)
            self.pool.register(int(self.block_tables[i, jb]), h)

    def step(self):
        """One engine iteration: admit -> one unified mixed step (the
        padded grid, or its flattened tokens when ``packed``)."""
        this_step = self.iters
        self.iters += 1
        self._admit()
        tokens, n_new, slot_map, decode_slots, finishing = self._schedule()
        if not n_new.any():
            return
        if self.packed:
            flat, seg, pos, nn_, smap, last_idx, bucket = \
                self._flatten_grid(tokens, n_new, slot_map)
            lg, self.caches = self._step(
                self.params, {"tokens": _host(flat)}, self.caches,
                _host(pos), _host(nn_), _host(seg), _host(self.block_tables),
                _host(smap), _host(last_idx))
            self.grid_tokens += bucket
        else:
            lg, self.caches = self._step(
                self.params, {"tokens": _host(tokens)}, self.caches,
                _host(self.cache_len), _host(n_new),
                _host(self.block_tables), _host(slot_map))
            self.grid_tokens += self.slots * self.chunk
        old_len = self.cache_len.copy()
        self.cache_len += n_new
        self.scheduled_tokens += int(n_new.sum())
        self._last_slot_map = np.where(
            np.arange(self.chunk)[None, :] < n_new[:, None], slot_map, -1)
        for i in range(self.slots):
            t = int(n_new[i])
            if not t:
                continue
            if i not in decode_slots:
                self.slot_fill[i] += t
                self.scheduled_prefill_tokens += t
            self.slot_hist[i].extend(int(x) for x in tokens[i, :t])
            if self.prefix_reuse:
                self._register_completed(i, int(old_len[i]),
                                         int(old_len[i]) + t)
        toks = greedy_token(lg).cpu().numpy()        # the one d2h fetch
        self.d2h_fetches += 1
        for i in decode_slots + finishing:
            if i in finishing and self._skip_sample[i]:
                # a resumed decode's refill: its pending token is already
                # out_tokens[-1]; the (identical) re-sample is dropped
                self._skip_sample[i] = False
                continue
            req = self.slot_req[i]
            req.out_tokens.append(int(toks[i]))
            req.token_steps.append(this_step)
            self._finish_check(i)

    def _flatten_grid(self, tokens: np.ndarray, n_new: np.ndarray,
                      slot_map: np.ndarray):
        """The padded grid's scheduled tokens, slot-major, as one (T, 1)
        buffer: per-token segment ids, positions, 1/0 validity and write
        targets, plus each slot's last-token index.  T is bucketed up to
        the next power of two (``grid_tokens`` counts the bucket);
        padding rows carry seg -1, n_new 0, position 0 and the
        out-of-bounds write sentinel."""
        total = int(n_new.sum())
        bucket = 1 << max(0, total - 1).bit_length()
        oob = self.pool.num_blocks * self.block_size
        flat = np.zeros((bucket, 1), np.int32)
        seg = np.full((bucket,), -1, np.int32)
        pos = np.zeros((bucket,), np.int32)
        nn_ = np.zeros((bucket,), np.int32)
        smap = np.full((bucket, 1), oob, np.int32)
        last_idx = np.zeros((self.slots,), np.int32)
        t = 0
        for i in range(self.slots):
            k = int(n_new[i])
            if not k:
                continue
            flat[t:t + k, 0] = tokens[i, :k]
            seg[t:t + k] = i
            pos[t:t + k] = int(self.cache_len[i]) + np.arange(k)
            nn_[t:t + k] = 1
            smap[t:t + k, 0] = slot_map[i, :k]
            last_idx[i] = t + k - 1
            t += k
        return flat, seg, pos, nn_, smap, last_idx, bucket

    def _progress_signature(self) -> Tuple[int, ...]:
        """Monotone counters that move whenever an iteration did work:
        scheduling, finishing, preempting, admitting or restoring."""
        return (self.scheduled_tokens, len(self.finished),
                self.preemptions, self.admitted_prompt_tokens,
                self.prefix_hit_tokens, self.swapped_in_tokens)

    def _pending(self) -> str:
        active = {self.slot_req[i].uid:
                  f"slot {i}: fill {int(self.slot_fill[i])}/"
                  f"{len(self.slot_prompt[i])}, cache_len "
                  f"{int(self.cache_len[i])}, blocks "
                  f"{int(self.slot_nblocks[i])}"
                  for i in self._active_slots()}
        return (f"queued uids={[r.uid for r in self.queue]}, "
                f"active={active}, pool: {self.pool.blocks_free} free / "
                f"{self.pool.blocks_in_use} in use / "
                f"{self.pool.blocks_cached} cached of "
                f"{self.pool.num_blocks} blocks, preempt={self.preempt!r}")

    def run_until_done(self, max_iters: int = 10000,
                       stall_iters: int = 8) -> List[Request]:
        """Drive ``step()`` until every submitted request finishes; raises
        on the iteration cap or on ``stall_iters`` steps without
        progress."""
        it = stalled = 0
        sig = self._progress_signature()
        while self.queue or self._active_slots():
            if it >= max_iters:
                raise RuntimeError(f"run_until_done: work remains after "
                                   f"{it} iterations: " + self._pending())
            self.step()
            it += 1
            new_sig = self._progress_signature()
            stalled = stalled + 1 if new_sig == sig else 0
            sig = new_sig
            if stalled >= stall_iters:
                raise RuntimeError(f"run_until_done: no progress for "
                                   f"{stalled} iterations: "
                                   + self._pending())
        return self.finished

    # -- introspection / invariants ----------------------------------------

    @property
    def output_tokens(self) -> int:
        live = sum(len(self.slot_req[i].out_tokens)
                   for i in self._active_slots())
        return live + sum(len(r.out_tokens) for r in self.finished) \
            + sum(len(r.out_tokens) for r in self.queue)

    def stats(self) -> Dict[str, int]:
        """Cumulative counters, plus the gauges blocks_in_use,
        blocks_cached, preempted_waiting and preemptable_pool."""
        return {
            "steps": self.iters,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "scheduled_tokens": self.scheduled_tokens,
            "grid_tokens": self.grid_tokens,
            "scheduled_prefill_tokens": self.scheduled_prefill_tokens,
            "admitted_prompt_tokens": self.admitted_prompt_tokens,
            "cow_copies": self.cow_copies,
            "blocks_in_use": self.pool.blocks_in_use,
            "blocks_cached": self.pool.blocks_cached,
            "evictions": self.pool.evictions,
            "preemptions": self.preemptions,
            "swapped_out_blocks": self.swapped_out_blocks,
            "swapped_in_blocks": self.swapped_in_blocks,
            "swapped_in_tokens": self.swapped_in_tokens,
            "swap_d2h_fetches": self.swap_d2h_fetches,
            "recompute_tokens": self.recompute_tokens,
            "truncated_requests": self.truncated_requests,
            "finished_requests": len(self.finished),
            "output_tokens": self.output_tokens,
            "d2h_fetches": self.d2h_fetches,
            "preempted_waiting": len(self._resume),
            "preemptable_pool": int(self.preemptable),
        }

    def validate(self):
        """Assert the pool/table invariants (host-side only): refcounts
        equal table multiplicity, tables are dense prefixes sized
        ceil(cache_len / block_size), histories match cache lengths,
        partial tail blocks are exclusively owned, donated tails hold no
        reference, the last step's write targets were disjoint, and every
        preempted request waits in the queue and nowhere else."""
        self.pool.check()
        counts = np.zeros((self.pool.num_blocks,), np.int64)
        for i in range(self.slots):
            nb_i = int(self.slot_nblocks[i])
            if self.slot_req[i] is None:
                assert nb_i == 0 and (self.block_tables[i] == -1).all(), i
                assert not self.slot_hist[i] and not self.slot_chain[i], i
                continue
            cl = int(self.cache_len[i])
            bids = self.block_tables[i, :nb_i]
            assert (bids >= 0).all(), (i, bids)
            assert (self.block_tables[i, nb_i:] == -1).all(), i
            assert nb_i == -(-cl // self.block_size), (i, nb_i, cl)
            assert len(self.slot_hist[i]) == cl, (i, cl)
            np.add.at(counts, bids, 1)
            if cl % self.block_size:
                tail = int(self.block_tables[i, cl // self.block_size])
                assert self.pool.refcount[tail] == 1, (i, tail)
        for bid in self._tail_cache:
            assert counts[bid] == 0, (bid, counts[bid])
        assert (self.pool.refcount == counts).all(), \
            (self.pool.refcount, counts)
        if self._last_slot_map is not None:
            written = self._last_slot_map[self._last_slot_map >= 0]
            assert len(np.unique(written)) == len(written), written
        queued = {r.uid for r in self.queue}
        active = {self.slot_req[i].uid for i in self._active_slots()}
        for uid in self._resume:
            assert uid in queued and uid not in active, uid

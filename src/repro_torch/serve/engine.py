"""Serving engine: ternarized weights, token-budget continuous batching.

The port of the reference engine's core (``repro/serve/engine.py``):

  * ``ternarize_model`` converts master weights into TiM serving codes
    (int8, or 2-bit packed);
  * ``ServeEngine`` is the chunked-prefill continuous-batching scheduler
    around ONE step of fixed shape (``batch_slots``, ``chunk``):
    ``make_paged_unified_step`` — the unified mixed prefill/decode step
    over a block-paged KV pool (serve/block_pool).  Every iteration
    schedules one token per decoding slot first, then prompt slices
    under the ``token_budget``;
  * cross-request prefix reuse: admission chain-hashes the prompt's full
    blocks and re-references resident ones; a partially matching tail
    block (a live slot's or one a finished request donated) is copied
    (``copy_kv_block``) before the newcomer writes into it;
  * greedy decoding; ``stats()`` exposes the counters.

Not ported yet (constructor or ``submit`` raises NotImplementedError):
the token-packed layout, speculative decoding, sampling, ``n > 1``
siblings, beam search, guided masks, and pools below the full-batch
floor (preemption/swap).

Host/device hand-off: all scheduler state is host numpy.  Each step
hands the model private CPU copies of every scheduler array (tokens,
cache_len, n_new, block tables, slot map), so later in-place host
updates can never reach what a step reads, however the copy to the
device is ordered.  The only device-to-host transfer per step is the
fetch of the greedy tokens (``d2h_fetches``).
"""
from __future__ import annotations

import dataclasses
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


def copy_kv_block(caches, src: int, dst: int):
    """Copy one physical KV block (every layer; K, V and any scales) in
    place — the copy-on-write primitive of partial-tail prefix sharing."""
    for layer in caches:
        for key in _KV_KEYS:
            if key in layer:
                layer[key][dst] = layer[key][src]
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


def _host(a: np.ndarray) -> torch.Tensor:
    """A private CPU tensor copy of a scheduler array (never aliases)."""
    return torch.from_numpy(np.array(a, copy=True))


class ServeEngine:
    """Chunked-prefill continuous batching over a block-paged KV pool.

    One step of fixed shape (``batch_slots``, ``chunk``) serves prefill
    and decode; ``token_budget`` bounds the real tokens per iteration
    (decodes first).  The KV cache is a global pool of ``num_blocks`` x
    ``block_size`` blocks addressed through per-slot block tables; with
    ``prefix_reuse`` admission re-references resident prompt blocks and
    copies a matching partial tail block before writing.  ``device``
    defaults to CUDA (raises without it).
    """

    def __init__(self, params, cfg: ArchConfig, batch_slots: int,
                 max_len: int, greedy: bool = True, chunk: int = 16,
                 token_budget: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefix_reuse: bool = True,
                 packed: bool = False, spec_k: int = 0, device="cuda"):
        if chunk < 1:
            raise ValueError(f"chunk {chunk} < 1")
        for flag, what in ((packed, "packed=True (token-packed layout)"),
                           (spec_k, "spec_k > 0 (speculative decoding)"),
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
        if num_blocks < batch_slots * self.max_blocks + 1:
            raise NotImplementedError(
                "pools below the full-batch floor (slots * ceil(max_len / "
                "block_size) + 1 blocks) need preemption, which is not "
                "ported yet")
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
        self._step = make_paged_unified_step(cfg)

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

    def _alloc_block(self) -> int:
        bid = self.pool.try_allocate()
        if bid is None:
            # unreachable at the full-batch floor the constructor enforces
            raise RuntimeError("block pool exhausted: " + self._pending())
        self._tail_cache.pop(bid, None)
        return bid

    def _cow_block(self, slot: int, jb: int, src: int) -> int:
        """Copy-on-write: deep-copy block ``src`` into a fresh block at
        this slot's table entry ``jb``, before the slot's first write."""
        dst = self._alloc_block()
        self.caches = copy_kv_block(self.caches, src, dst)
        self.cow_copies += 1
        self.block_tables[slot, jb] = dst
        self.slot_nblocks[slot] = jb + 1
        return dst

    def _admit(self):
        """Assign queued requests to free slots: prefix matching jumps the
        prompt cursor over resident blocks; a partial-tail hit costs one
        block copy.  No forward pass happens here."""
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            if self.pool.blocks_free < 1 and self._active_slots():
                break
            req = self.queue.pop(0)
            tokens_in = np.asarray(req.prompt, np.int32)
            plen = len(tokens_in)
            self.admitted_prompt_tokens += plen

            matched, hits, chain = (
                self._match_full_blocks(tokens_in) if self.prefix_reuse
                else (0, [], []))
            cow_src, cow_take, cow_release = -1, 0, -1
            if matched >= plen:
                # whole-prompt hit: re-own the last block so its final
                # position can be recomputed for logits
                cow_src = hits.pop()
                chain.pop()
                matched -= self.block_size
                cow_take, cow_release = self.block_size - 1, cow_src
            elif self.prefix_reuse:
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
            if cow_src >= 0 and cow_take > 0:
                self._cow_block(slot, len(hits), cow_src)
                matched += cow_take
            if cow_release >= 0:
                self.pool.decref(cow_release)
            req.prefix_hit_tokens = matched
            self.prefix_hit_tokens += matched
            self.slot_hist[slot] = [int(t) for t in tokens_in[:matched]]
            self.slot_fill[slot] = matched
            self.cache_len[slot] = matched

    def _ensure_blocks(self, i: int, upto_len: int):
        need = -(-upto_len // self.block_size)
        while self.slot_nblocks[i] < need:
            self.block_tables[i, self.slot_nblocks[i]] = self._alloc_block()
            self.slot_nblocks[i] += 1

    def _schedule(self):
        """Fill the (slots, chunk) grid: decodes first, then prompt
        slices under the remaining budget; build the physical write map
        (slot_map) and allocate the blocks the tokens land in."""
        tokens = np.zeros((self.slots, self.chunk), np.int32)
        n_new = np.zeros((self.slots,), np.int32)
        oob = self.pool.num_blocks * self.block_size
        slot_map = np.full((self.slots, self.chunk), oob, np.int32)
        decode_slots: List[int] = []
        finishing_prefill: List[int] = []

        def write_map(i, t):
            pos = int(self.cache_len[i]) + np.arange(t)
            blk = self.block_tables[i, pos // self.block_size]
            slot_map[i, :t] = blk * self.block_size + pos % self.block_size

        budget = self.token_budget
        for i in self._active_slots():
            if self.slot_fill[i] >= len(self.slot_prompt[i]):
                self._ensure_blocks(i, int(self.cache_len[i]) + 1)
                tokens[i, 0] = self.slot_req[i].out_tokens[-1]
                n_new[i] = 1
                write_map(i, 1)
                decode_slots.append(i)
                budget -= 1   # decode is never stalled, even if < 0
        for i in self._active_slots():
            plen = len(self.slot_prompt[i])
            fill = int(self.slot_fill[i])
            if fill >= plen or budget <= 0:
                continue
            take = min(self.chunk, plen - fill, budget)
            self._ensure_blocks(i, int(self.cache_len[i]) + take)
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
        """One engine iteration: admit -> one unified mixed step."""
        this_step = self.iters
        self.iters += 1
        self._admit()
        tokens, n_new, slot_map, decode_slots, finishing = self._schedule()
        if not n_new.any():
            return
        lg, self.caches = self._step(
            self.params, {"tokens": _host(tokens)}, self.caches,
            _host(self.cache_len), _host(n_new), _host(self.block_tables),
            _host(slot_map))
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
            req = self.slot_req[i]
            req.out_tokens.append(int(toks[i]))
            req.token_steps.append(this_step)
            self._finish_check(i)

    def _progress_signature(self) -> Tuple[int, ...]:
        return (self.scheduled_tokens, len(self.finished),
                self.admitted_prompt_tokens, self.prefix_hit_tokens)

    def _pending(self) -> str:
        active = {self.slot_req[i].uid:
                  f"slot {i}: fill {int(self.slot_fill[i])}/"
                  f"{len(self.slot_prompt[i])}, cache_len "
                  f"{int(self.cache_len[i])}"
                  for i in self._active_slots()}
        return (f"queued uids={[r.uid for r in self.queue]}, "
                f"active={active}, pool: {self.pool.blocks_free} free of "
                f"{self.pool.num_blocks}")

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
        """Cumulative counters, plus the gauges blocks_in_use and
        blocks_cached."""
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
            "truncated_requests": self.truncated_requests,
            "finished_requests": len(self.finished),
            "output_tokens": self.output_tokens,
            "d2h_fetches": self.d2h_fetches,
        }

    def validate(self):
        """Assert the pool/table invariants (host-side only)."""
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

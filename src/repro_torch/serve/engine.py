"""Serving engine: ternarized weights, token-budget continuous batching.

The port of the reference engine (``repro/serve/engine.py``) for dense
attention stacks:

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
  * decoding: greedy, or sampled (``greedy=False``) from per-request
    counter-based streams — token t of sibling s of request uid draws
    from ``derive_sample_key(base, uid, s, t)`` (``core/prng``, the
    reference's ``jax.random`` threefry bit for bit), so a sampled
    rollout does not depend on occupancy, layout or preemption;
    ``Request(n=...)`` siblings share the prompt's blocks (one
    prefill); ``sample_mode='beam'`` runs width-n beam search over the
    copy-on-write fork path; ``allowed_tokens`` masks constrain every
    sampled position through a compact (slots, ``mask_width``) buffer;
  * self-speculative decoding (``spec_k > 0``): a draft pass over the
    same codes through a cheaper activation encoding
    (``TernaryPolicy.draft``, e.g. int2 against an int4 target)
    proposes up to ``spec_k`` tokens per decoding slot, the target
    verifies them in one mixed step, and a rejected suffix rolls back
    (``_step_spec``); ``stats()`` exposes the counters.

Outside the port (``NotImplementedError``): media inputs, and every
non-dense stack (``models/transformer._check_dense``).

Host/device hand-off: all scheduler state is host numpy.  Each step
hands the model private CPU copies of every scheduler array (tokens,
cache_len, n_new, block tables, slot map), so later in-place host
updates can never reach what a step reads, however the copy to the
device is ordered.  The sampler's PRNG keys are derived on the host
from those arrays; the only device-to-host transfer per step is one
fetch of the step's tokens (with the beam candidates, and the spec
step's emissions and counts, in the same buffer: ``d2h_fetches``),
plus one per speculative draft pass (``draft_d2h_fetches``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.core.ternary import TernaryScales
from repro_torch.core.weights import TernaryWeight
from repro_torch.models import transformer as tfm
from repro_torch.nn.linear import ternarize_dense_params
from repro_torch.serve.block_pool import (ROOT_HASH, BlockPool, chain_hash,
                                          default_num_blocks)

_TERNARY_LAYER_KEYS = {"q", "k", "v", "o", "gate", "up", "down"}
_KV_KEYS = ("k", "v", "k_scale", "v_scale")

# Swap-vs-recompute crossover defaults: 989 TFLOP/s bf16 dense for
# replaying dropped tokens (the H100 SXM's published peak, NVIDIA data
# sheet), and 44 GB/s for the host link a swap crosses twice: the
# page-locked device-to-host copy of fetch_kv_blocks as chip_smoke.py
# measures it on an NVIDIA H100 80GB HBM3 at a 700 W power limit
# (43.5-44.8 GB/s over 41 MB swaps; the PCIe Gen5 x16 data-sheet peak
# is 64 GB/s).
H100_BF16_FLOPS = 989e12
H100_HOST_LINK_BW = 44e9


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


def _column_logits(params, cfg: ArchConfig, rows: torch.Tensor,
                   cols: torch.Tensor):
    """Logits of the (slots, C, d) hidden rows at grid columns ``cols``
    (slots, J), one column at a time: every head product has M = slots
    rows, as the unified step's has, so a position's logits are the same
    bits whichever step computes them (the lossless contract of greedy
    speculation)."""
    idx = cols.to(rows.device).long()[..., None]
    rows = rows.gather(1, idx.expand(-1, -1, rows.shape[-1]))
    return torch.stack([tfm.logits(params, cfg, rows[:, j:j + 1])[:, 0]
                        for j in range(rows.shape[1])], dim=1)


def make_draft_step(cfg: ArchConfig, impl: Optional[str] = None):
    """The speculative DRAFT step: the paged unified step at chunk 1,
    built from the cheap-encoding draft config (the target's codes read
    through ``TernaryPolicy.draft``).  Proposals are the masked greedy
    argmax, made on the device, so the host fetches one token per slot
    per draft pass: a deterministic proposal (q = delta at the argmax),
    which reduces exact rejection sampling to accepting d with
    probability p(d) in the verify step."""
    def draft_step(params, batch, caches, cache_len, n_new, block_tables,
                   slot_map, mask):
        hidden, caches, _ = tfm.forward(
            params, cfg, batch, mode="mixed", caches=caches,
            cache_len=cache_len, n_new=n_new, block_tables=block_tables,
            slot_map=slot_map, impl=impl)
        lg = tfm.logits(params, cfg, hidden[:, :1])[:, 0]
        return greedy_token(apply_token_masks(lg, mask)), caches
    return draft_step


def make_paged_spec_step(cfg: ArchConfig, impl: Optional[str] = None):
    """The padded VERIFY step: ``make_paged_unified_step`` returning the
    logits of grid positions (slots, J, vocab): column j of a decode
    slot predicts position cache_len + j + 1, which judges draft token
    j + 1.  ``cols`` (slots, J) names each slot's columns: the engine
    asks for the ones its accept function reads (the reference returns
    every column).  The verify forward overwrites the draft passes'
    cheap-encoding KV with target KV at every scheduled position."""
    def paged_spec_step(params, batch, caches, cache_len, n_new,
                        block_tables, slot_map, cols):
        hidden, caches, _ = tfm.forward(
            params, cfg, batch, mode="mixed", caches=caches,
            cache_len=cache_len, n_new=n_new, block_tables=block_tables,
            slot_map=slot_map, impl=impl)
        return _column_logits(params, cfg, hidden, cols), caches
    return paged_spec_step


def make_packed_spec_step(cfg: ArchConfig, impl: Optional[str] = None):
    """The token-packed VERIFY step: the flat layout.  ``row_idx``
    (slots, chunk) holds the flat index of each slot's j-th scheduled
    token (rows past ``n_new`` point at 0 and are never read), so the
    logits at ``cols`` keep the padded verify step's (slots, J, vocab)
    shape and one accept function serves both layouts."""
    def packed_spec_step(params, batch, caches, positions, n_new, seg_ids,
                         block_tables, slot_map, row_idx, cols):
        hidden, caches, _ = tfm.forward(
            params, cfg, batch, mode="mixed", caches=caches,
            cache_len=positions, n_new=n_new, block_tables=block_tables,
            slot_map=slot_map, impl=impl, seg_ids=seg_ids)
        rows = hidden[row_idx.to(hidden.device).long(), 0]  # (slots, C, d)
        return _column_logits(params, cfg, rows, cols), caches
    return packed_spec_step


def copy_kv_block(caches, src: int, dst: int):
    """Copy one physical KV block (every layer; K, V and any scales) in
    place — the copy-on-write primitive of partial-tail prefix sharing."""
    for layer in caches:
        for key in _KV_KEYS:
            if key in layer:
                layer[key][dst] = layer[key][src]
    return caches


def fetch_kv_blocks(caches, bids,
                    split: Optional[Dict[str, float]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Device -> host copy of physical KV blocks ``bids`` (every layer;
    K, V and any scales): the swap-out half of preemption.  Returns
    {key: (layers, len(bids), block_size, ...) CPU tensor}, all carved
    from ONE host buffer.  A CUDA cache is gathered on the device and
    copied into page-locked memory by one ``non_blocking`` copy, then one
    synchronisation of the stream, so no later host write can race the
    copy; a CPU cache is gathered in place.  ``split`` (optional) gets
    the seconds of the gather and the copy (device time, CUDA events)
    and of the synchronisation (host wait) added under "gather", "copy"
    and "sync"."""
    dev = caches[0]["k"].device
    keys = [k for k in _KV_KEYS if k in caches[0]]
    n = len(bids)
    shapes = [(len(caches), n) + tuple(caches[0][k].shape[1:]) for k in keys]
    sizes = [int(np.prod(s)) * caches[0][k].element_size()
             for s, k in zip(shapes, keys)]
    cuda = dev.type == "cuda"
    if cuda:   # allocated before the timed span
        host = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
    timed = cuda and split is not None
    if timed:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    idx = torch.as_tensor(np.asarray(bids, np.int64), device=dev)
    parts = [torch.stack([layer[k].index_select(0, idx) for layer in caches])
             for k in keys]
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])
    if cuda:
        if timed:
            ev[1].record()
        host.copy_(flat, non_blocking=True)
        if timed:
            ev[2].record()
        t0 = time.perf_counter()
        torch.cuda.current_stream(dev).synchronize()
        if timed:
            split["sync"] = split.get("sync", 0.0) + time.perf_counter() - t0
            for name, a, b in (("gather", 0, 1), ("copy", 1, 2)):
                split[name] = split.get(name, 0.0) \
                    + ev[a].elapsed_time(ev[b]) / 1e3
    else:
        host = flat
    out, off = {}, 0
    for k, shape, size in zip(keys, shapes, sizes):
        out[k] = host[off:off + size].view(caches[0][k].dtype).reshape(shape)
        off += size
    return out


def write_kv_blocks(caches, dsts: Sequence[int],
                    values: Sequence[Dict[str, torch.Tensor]]) -> int:
    """Host -> device restore of physical blocks ``dsts``, each from a
    ``fetch_kv_blocks``-shaped tree sliced to one block ({key: (layers,
    block_size, ...)}): the swap-in half, written in place.  The blocks
    are packed into one host buffer (page-locked for a CUDA cache, which
    the host never writes again) and go up in ONE ``non_blocking``
    host-to-device copy, then one indexed write per layer and key, all
    in stream order.  Returns the bytes copied."""
    if not dsts:
        return 0
    dev = caches[0]["k"].device
    keys = list(values[0])
    n = len(dsts)
    shapes = [(len(caches), n) + tuple(values[0][k].shape[1:]) for k in keys]
    dtypes = [values[0][k].dtype for k in keys]
    sizes = [int(np.prod(s)) * values[0][k].element_size()
             for s, k in zip(shapes, keys)]
    host = torch.empty(sum(sizes), dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    regions, off = [], 0
    for k, shape, dt, size in zip(keys, shapes, dtypes, sizes):
        region = host[off:off + size].view(dt).view(shape)
        for i, v in enumerate(values):
            region[:, i].copy_(v[k])
        regions.append((k, off, size, dt, shape))
        off += size
    dv = host.to(dev, non_blocking=True)
    idx = torch.as_tensor(np.asarray(dsts, np.int64), device=dev)
    for k, off, size, dt, shape in regions:
        rows = dv[off:off + size].view(dt).view(shape)
        for layer, row in zip(caches, rows):
            layer[k].index_copy_(0, idx, row)
    return int(host.numel())


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# sampling: per-request counter-based streams (core/prng)
# ---------------------------------------------------------------------------

def sample_token(logits: torch.Tensor, key: Optional[torch.Tensor] = None,
                 temperature: float = 1.0) -> torch.Tensor:
    """Sample (or argmax) the next token.  Key consumption is explicit:
    greedy routing (``temperature <= 0``) takes ``key=None`` and consumes
    nothing; sampling requires a key.  ``key`` is one (2,) key for the
    whole ``logits`` array or one key per row ((..., 2) against (...,
    vocab)), each drawing ``jax.random.categorical`` of its rows."""
    if temperature <= 0:
        if key is not None:
            raise ValueError(
                "sample_token with temperature <= 0 is greedy and "
                "consumes no PRNG key; pass key=None — key consumption "
                "must be explicit and identical across code paths")
        return greedy_token(logits)
    if key is None:
        raise ValueError("sample_token with temperature > 0 draws from the "
                         "PRNG stream and requires a key")
    return prng.categorical(key.to(logits.device),
                            logits.float() / temperature).to(torch.int32)


def derive_sample_key(base_key: torch.Tensor, uid, sample_index,
                      token_index) -> torch.Tensor:
    """The per-request stream: ``fold_in(fold_in(fold_in(base, uid),
    sample_index), token_index)``, a pure function of the request's
    identity and position (not of slot, step or schedule).  The three
    coordinates may be tensors; they broadcast."""
    k = prng.fold_in(base_key, uid)
    k = prng.fold_in(k, sample_index)
    return prng.fold_in(k, token_index)


def apply_token_masks(logits: torch.Tensor, mask) -> torch.Tensor:
    """Guided decoding: constrain (slots, vocab) logits to a compact
    (slots, mask_width) buffer of allowed ids padded with -1 (a row of
    all -1 is unconstrained).  Returns float32 logits with every other
    id at -1e30.  Only the compact buffer crosses to the device."""
    lg = logits.float()
    mask = torch.as_tensor(mask).to(lg.device).long()
    vocab = lg.shape[-1]
    valid = mask >= 0
    hits = torch.zeros(lg.shape, dtype=torch.int32, device=lg.device)
    hits.scatter_add_(-1, mask.clamp(0, vocab - 1), valid.to(torch.int32))
    keep = (hits > 0) | ~valid.any(-1, keepdim=True)
    return torch.where(keep, lg, torch.full_like(lg, -1e30))


def _ids(ids) -> torch.Tensor:
    """(slots, 3) stream coordinates (uid, sample_index, token_index) as
    a host int64 tensor."""
    if isinstance(ids, torch.Tensor):
        return ids.cpu().long()
    return torch.from_numpy(np.asarray(ids, np.int64))


def make_sample_fn(temperature: float, topk: int):
    """The per-step sampling tail: mask application, per-request
    ``derive_sample_key`` streams (keys derived on the host from the
    stream coordinates; the draw on the logits' device), categorical (or
    argmax) selection and, when ``topk`` > 0, the top-k log-prob
    candidates the host's beam bookkeeping consumes (ties to the lower
    id, as ``jax.lax.top_k``: a stable descending sort)."""
    def sample_fn(lg, base_key, ids, mask):
        lgm = apply_token_masks(lg, mask)
        if temperature <= 0:
            toks = sample_token(lgm, None, temperature)
        else:
            c = _ids(ids)
            keys = derive_sample_key(base_key.cpu(), c[:, 0], c[:, 1],
                                     c[:, 2])
            toks = sample_token(lgm, keys, temperature)
        if topk:
            lp = torch.log_softmax(lgm, dim=-1)
            cand_lp, cand_ids = torch.sort(lp, dim=-1, descending=True,
                                           stable=True)
            return (toks, cand_ids[:, :topk].to(torch.int32),
                    cand_lp[:, :topk])
        return toks
    return sample_fn


# one sampler per (temperature, topk), shared by every engine
_SAMPLERS: Dict[Tuple[float, int], Callable] = {}


def _get_sampler(temperature: float, topk: int):
    key = (float(temperature), int(topk))
    if key not in _SAMPLERS:
        _SAMPLERS[key] = make_sample_fn(*key)
    return _SAMPLERS[key]


# sub-stream tags of the acceptance test and of the rejection resample,
# folded onto a position's key, so the BONUS draw (emission j == k)
# consumes the raw derive_sample_key(base, uid, si, t0 + j): a spec
# engine that drafts nothing emits what the non-spec sampled engine does
_SPEC_ACCEPT_TAG = 1
_SPEC_RESAMPLE_TAG = 2


def make_spec_accept_fn(temperature: float):
    """Speculative acceptance over the verify step's all-position logits.

    Per slot, column ``start + j`` of ``lg`` (slots, C, vocab) scores
    emission j (token index ``ids[:, 2] + j``); draft token j + 1 sits
    at column ``start + j + 1`` of ``toks`` (as wide as ``lg``, or, for
    logits gathered at columns 0 .. C - 1 of a wider grid, one wider).  Greedy engines accept while the masked argmax reproduces the
    draft; sampled engines run exact rejection sampling against the
    deterministic draft: accept d with probability p(d) (a uniform from
    the ACCEPT sub-key), else draw the correction from p with d banned
    (RESAMPLE sub-key); the bonus after an all-accepted run draws from
    the raw key.  Only emissions 0 .. max(n_draft) are evaluated (the
    reference evaluates every column; the host never reads past
    ``n_emit``).  Returns (emitted (slots, C) int32, n_emit (slots,)
    int32 = accepted run + 1)."""
    def accept_fn(lg, toks, start, n_draft, base_key, ids, masks):
        dev = lg.device
        s, c, vocab = lg.shape
        start = torch.as_tensor(start).cpu().long()
        n_draft = torch.as_tensor(n_draft).cpu().long()
        n_pos = min(c, int(n_draft.max()) + 1 if n_draft.numel() else 1)
        jj = torch.arange(n_pos)
        cols = (start[:, None] + jj).clamp(0, c - 1)
        toks = torch.as_tensor(toks).cpu().long()
        d_next = toks.gather(
            1, (start[:, None] + jj + 1).clamp(0, toks.shape[1] - 1)
        ).to(dev)
        in_draft = (jj[None, :] < n_draft[:, None]).to(dev)
        rows = lg.gather(1, cols.to(dev)[..., None].expand(s, n_pos, vocab))
        m = torch.as_tensor(masks)[:, :n_pos]
        lgm = apply_token_masks(rows.reshape(s * n_pos, vocab),
                                m.reshape(s * n_pos, -1)
                                ).reshape(s, n_pos, vocab)
        if temperature <= 0:
            e = lgm.argmax(-1)
            acc = in_draft & (e == d_next)
        else:
            c3 = _ids(ids)
            key = derive_sample_key(base_key.cpu(), c3[:, 0, None],
                                    c3[:, 1, None], c3[:, 2, None] + jj)
            u = prng.uniform(prng.fold_in(key, _SPEC_ACCEPT_TAG)).to(dev)
            scaled = lgm / temperature
            p = torch.softmax(scaled, dim=-1).gather(
                -1, d_next[..., None])[..., 0]
            acc = in_draft & (u < p)
            banned = lgm.scatter(-1, d_next[..., None], float("-inf"))
            resample = prng.categorical(
                prng.fold_in(key, _SPEC_RESAMPLE_TAG).to(dev),
                banned / temperature)
            bonus = prng.categorical(key.to(dev), scaled)
            e = torch.where(acc, d_next, torch.where(in_draft, resample,
                                                     bonus))
        a = torch.cumprod(acc.to(torch.int32), dim=1).sum(1)
        emitted = torch.zeros((s, c), dtype=torch.int32, device=dev)
        emitted[:, :n_pos] = e.to(torch.int32)
        return emitted, (a + 1).to(torch.int32)
    return accept_fn



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
    # parallel sampling: n > 1 expands into n siblings sharing the uid
    # (and the prompt's full blocks: one prefill); 'independent' draws
    # each from its own stream (sample_index), 'beam' runs width-n beam
    # search (cum_logprob is a hypothesis' score); the parent never
    # enters the queue, its children are ``siblings``
    n: int = 1
    sample_mode: str = "independent"
    sample_index: int = 0
    siblings: Optional[List["Request"]] = None
    cum_logprob: float = 0.0
    # guided decoding: callback(out_tokens) -> allowed ids of the next
    # position (None: unconstrained)
    allowed_tokens: Optional[Callable[[List[int]], Optional[Sequence[int]]]] \
        = None

    @property
    def first_token_step(self) -> int:
        """Step index of the first emitted token (-1 before it exists)."""
        return self.token_steps[0] if self.token_steps else -1


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
    can then livelock, and ``run_until_done`` raises).

    Decoding: ``greedy`` (argmax) or sampled at ``temperature`` from the
    streams of ``seed``; ``allowed_tokens`` rows of up to ``mask_width``
    ids; ``oversize`` 'error' rejects a prompt longer than ``max_len`` at
    ``submit``, 'truncate' keeps its last ``max_len`` tokens.  ``spec_k``
    > 0 drafts up to that many tokens per decoding slot through
    ``draft_act_mode`` (leftover budget only) and verifies them in the
    step.  ``device`` defaults to CUDA (raises without it).
    """

    def __init__(self, params, cfg: ArchConfig, batch_slots: int,
                 max_len: int, greedy: bool = True, seed: int = 0,
                 oversize: str = "error", chunk: int = 16,
                 token_budget: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefix_reuse: bool = True,
                 preempt: str = "auto", packed: bool = False,
                 temperature: float = 1.0, mask_width: int = 8,
                 spec_k: int = 0, draft_act_mode: str = "int2",
                 peak_flops: float = H100_BF16_FLOPS,
                 host_link_bw: float = H100_HOST_LINK_BW, device="cuda"):
        if chunk < 1:
            raise ValueError(f"chunk {chunk} < 1")
        if preempt not in ("auto", "swap", "recompute", "none"):
            raise ValueError(f"preempt {preempt!r}: expected 'auto', "
                             f"'swap', 'recompute' or 'none'")
        if oversize not in ("error", "truncate"):
            raise ValueError(f"oversize {oversize!r}: expected 'error' or "
                             f"'truncate'")
        if temperature <= 0 and not greedy:
            raise ValueError(f"temperature {temperature} <= 0 is spelled "
                             f"greedy=True")
        if mask_width < 1:
            raise ValueError(f"mask_width {mask_width} < 1")
        if spec_k < 0:
            raise ValueError(f"spec_k {spec_k} < 0")
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
        self.greedy = bool(greedy)
        self.oversize = oversize
        self.temperature = float(temperature)
        self.mask_width = int(mask_width)
        # every sampled key is derived on the host from this base key
        self._base_key = prng.prng_key(seed)
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
        # the host swap arena ((uid, sample_index) -> resume prompt +
        # saved blocks; siblings preempt and resume independently) and
        # the per-slot flag that stops a resumed decode's refill from
        # re-appending its pending token
        self._admit_seq = 0
        self.slot_seq = np.zeros((batch_slots,), np.int64)
        self._resume: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._skip_sample = np.zeros((batch_slots,), bool)
        self.preemptions = 0
        self.swapped_out_blocks = 0
        self.swapped_in_blocks = 0
        self.swapped_in_tokens = 0
        self.recompute_tokens = 0
        self.swap_d2h_fetches = 0
        self.swap_d2h_bytes = 0          # host-side size of the arena
        self.swap_d2h_seconds = 0.0      # wall time of the swap-out copies
        # the swap-out span split (gather, copy: device s; sync: host s),
        # the swap-in copies (host s: packing and enqueue; the copy runs
        # in stream order), and each preemption's swap/recompute choice
        self.swap_split: Dict[str, float] = {}
        self.swap_h2d_copies = 0
        self.swap_h2d_bytes = 0
        self.swap_h2d_seconds = 0.0
        self.preempt_choices = {"swap": 0, "recompute": 0}
        # parallel sampling / beam / guided decoding
        self.sibling_requests = 0    # sample_index > 0 admissions
        self.beam_forks = 0          # beam hypothesis adoptions (CoW)
        self.masked_tokens = 0       # emitted positions under a mask row
        # live beam groups: uid -> its n sibling Requests
        self._beam_groups: Dict[int, List[Request]] = {}
        # speculative decoding (all zero when spec_k == 0):
        # draft_tokens == accepted + rejected after every step, and each
        # verify emits its accepted run plus one token (the correction,
        # or the bonus when every draft survived: bonus_tokens)
        self.draft_tokens = 0
        self.accepted_tokens = 0
        self.rejected_tokens = 0
        self.bonus_tokens = 0
        self.draft_d2h_fetches = 0   # one per draft pass
        # crossover inputs, counted as the reference counts them: every
        # tensor of the params tree, and the KV bytes of one block
        self._n_params = _count_params(params)
        self._block_bytes = sum(
            t.numel() * t.element_size() for layer in self.caches
            for t in layer.values()) / max(num_blocks, 1)
        self._step = (make_packed_unified_step(cfg) if self.packed
                      else make_paged_unified_step(cfg))
        self.spec_k = int(spec_k)
        self.draft_act_mode = draft_act_mode
        if self.spec_k:
            self._draft_cfg = cfg.replace(
                ternary=cfg.ternary.draft(draft_act_mode))
            self._draft_step = make_draft_step(self._draft_cfg)
            self._spec_step = (make_packed_spec_step(cfg) if self.packed
                               else make_paged_spec_step(cfg))
            self._accept = make_spec_accept_fn(
                0.0 if self.greedy else self.temperature)

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request):
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if plen > self.max_len and self.oversize != "truncate":
            raise ValueError(
                f"prompt of {plen} tokens exceeds the engine's cache "
                f"capacity max_len={self.max_len}; resubmit a shorter "
                f"prompt or construct the engine with oversize='truncate'")
        if req.media is not None:
            raise NotImplementedError(
                "media inputs (cross-attention stacks) are not ported")
        if req.sample_mode not in ("independent", "beam"):
            raise ValueError(f"unknown sample_mode {req.sample_mode!r}")
        if req.n < 1:
            raise ValueError(f"Request.n must be >= 1, got {req.n}")
        if req.sample_mode == "beam":
            if self.spec_k:
                raise ValueError(
                    "speculative decoding (spec_k > 0) does not compose "
                    "with beam search: beam expansion consumes per-slot "
                    "top-k candidates, not an accept/reject chain — "
                    "submit sample_mode='independent' or construct the "
                    "engine with spec_k=0")
            if self.greedy and req.n > 1:
                raise ValueError(
                    "beam search scores log-probs from the sampler — "
                    "construct the engine with greedy=False")
            if req.n > self.slots:
                raise ValueError(
                    f"beam width {req.n} exceeds batch_slots={self.slots}: "
                    f"every live hypothesis needs a slot for synchronized "
                    f"expansion")
        if req.n > 1:
            # n siblings share the uid; the parent never enters the queue
            kids = [dataclasses.replace(req, sample_index=s, siblings=None,
                                        out_tokens=[], token_steps=[])
                    for s in range(req.n)]
            req.siblings = kids
            if req.sample_mode == "beam":
                self._beam_groups[req.uid] = kids
            for kid in kids:
                kid.submit_step = self.iters
                self.queue.append(kid)
            return
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
            head = self.queue[0]
            res = self._resume.get((head.uid, head.sample_index))
            # a sibling waits for its leader (the same-uid slot admitted
            # first) to finish prefilling and register the prompt's full
            # blocks, then shares them by chain hash: one prefill serves
            # all n.  FIFO: admission stalls rather than skip it
            if head.sample_index > 0 and res is None and any(
                    self.slot_req[s] is not None
                    and self.slot_req[s].uid == head.uid
                    and self.slot_fill[s] < len(self.slot_prompt[s])
                    for s in range(self.slots)):
                break
            if self.pool.blocks_free < 1 and self._active_slots():
                break
            req = self.queue.pop(0)
            if res is not None:
                del self._resume[(req.uid, req.sample_index)]
                tokens_in = res["prompt"]
            else:
                if req.sample_index > 0:
                    self.sibling_requests += 1
                tokens_in = req.prompt
                if len(tokens_in) > self.max_len:
                    # oversize='truncate': the most recent context, the
                    # caller's Request untouched
                    tokens_in = tokens_in[len(tokens_in) - self.max_len:]
            tokens_in = np.asarray(tokens_in, np.int32)
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
        dsts: List[int] = []
        vals: List[Dict[str, torch.Tensor]] = []
        while jb in swap and matched == jb * bs:
            take = min(covered, (jb + 1) * bs) - jb * bs
            if take <= 0 or matched + take > cap:
                break
            bid = self._alloc_block()
            if bid is None:
                break                 # recompute the rest instead
            dsts.append(bid)
            vals.append(swap.pop(jb))
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
        if dsts:
            t0 = time.perf_counter()
            self.swap_h2d_bytes += write_kv_blocks(self.caches, dsts, vals)
            self.swap_h2d_seconds += time.perf_counter() - t0
            self.swap_h2d_copies += 1
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
        choice = self._swap_or_recompute(covered, len(own)) if own \
            else None
        if choice is not None:
            self.preempt_choices[choice] = \
                self.preempt_choices.get(choice, 0) + 1
        if choice == "swap":
            t0 = time.perf_counter()
            fetched = fetch_kv_blocks(self.caches, [b for _, b in own],
                                      self.swap_split)
            self.swap_d2h_seconds += time.perf_counter() - t0
            self.swap_d2h_bytes += sum(t.numel() * t.element_size()
                                       for t in fetched.values())
            self.swap_d2h_fetches += 1
            for pos, (jb, _) in enumerate(own):
                swap[jb] = {k: t[:, pos] for k, t in fetched.items()}
            self.swapped_out_blocks += len(own)
        self._resume[(req.uid, req.sample_index)] = {
            "prompt": eff, "decoding": bool(req.out_tokens),
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
            group = self._beam_groups.get(req.uid)
            if group is not None and all(k.done for k in group):
                del self._beam_groups[req.uid]

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
        padded grid, or its flattened tokens when ``packed``), or the
        speculative draft passes and verify step when ``spec_k`` > 0."""
        this_step = self.iters
        self.iters += 1
        self._admit()
        tokens, n_new, slot_map, decode_slots, finishing = self._schedule()
        if not n_new.any():
            return
        if self.spec_k:
            self._step_spec(this_step, tokens, n_new, slot_map,
                            decode_slots, finishing)
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
        # rows that emit a token this step (a row's token index is
        # len(out_tokens) before the append)
        sample_rows = decode_slots + [i for i in finishing
                                      if not self._skip_sample[i]]
        beam_rows = [i for i in sample_rows
                     if self.slot_req[i].sample_mode == "beam"]
        use_sampler = (not self.greedy) or bool(beam_rows) or any(
            self.slot_req[i].allowed_tokens is not None for i in sample_rows)
        cand_ids = cand_lps = None
        if not use_sampler:
            toks = greedy_token(lg).cpu().numpy()     # the one d2h fetch
        else:
            ids, mask = self._sample_inputs(sample_rows)
            topk = max((self.slot_req[i].n for i in beam_rows), default=0)
            sampler = _get_sampler(0.0 if self.greedy else self.temperature,
                                   topk)
            out = sampler(lg, self._base_key, ids, _host(mask))
            if topk:
                # tokens, candidate ids and the bits of their log-probs
                # in one buffer: still one fetch
                toks_d, ids_d, lps_d = out
                got = torch.cat([toks_d[:, None], ids_d,
                                 lps_d.contiguous().view(torch.int32)],
                                dim=1).cpu()
                toks = got[:, 0].numpy()
                cand_ids = got[:, 1:1 + topk].numpy()
                cand_lps = got[:, 1 + topk:].contiguous().view(
                    torch.float32).numpy()
            else:
                toks = out.cpu().numpy()
        self.d2h_fetches += 1
        beam_decode = [i for i in decode_slots if i in beam_rows]
        for i in decode_slots:
            if i in beam_decode:
                continue
            req = self.slot_req[i]
            req.out_tokens.append(int(toks[i]))
            req.token_steps.append(this_step)
            self._finish_check(i)
        if beam_decode:
            self._beam_decode(beam_decode, cand_ids, cand_lps, this_step)
        for i in finishing:
            if self._skip_sample[i]:
                # a resumed decode's refill: its pending token is already
                # out_tokens[-1]; the (identical) re-sample is dropped
                self._skip_sample[i] = False
                continue
            req = self.slot_req[i]
            if req.sample_mode == "beam":
                # beam root: sibling s seeds its hypothesis with the s-th
                # best first token (identical prompts give identical
                # logits, so this is the joint top-n of the root)
                req.out_tokens.append(int(cand_ids[i, req.sample_index]))
                req.cum_logprob += float(cand_lps[i, req.sample_index])
            else:
                req.out_tokens.append(int(toks[i]))
            req.token_steps.append(this_step)
            self._finish_check(i)

    def _step_spec(self, this_step: int, tokens: np.ndarray,
                   n_new: np.ndarray, slot_map: np.ndarray,
                   decode_slots: List[int], finishing: List[int]):
        """The speculative tail of ``step()``: extend each scheduled
        decode row with up to ``spec_k`` draft tokens funded by the
        LEFTOVER token budget (decodes and prefill chunks keep priority),
        run that many draft passes to propose them, verify all k + 1
        positions in ONE mixed step of the engine's layout, and accept
        or roll back.

        Rollback: the verify forward wrote target KV at positions
        [cache_len, cache_len + k]; acceptance of ``a`` drafts commits
        coverage cache_len + 1 + a, so ``cache_len`` retreats to it (the
        suffix is masked by length and overwritten later) and every
        block past it is released.  Chain-hash registration waits for
        accepted coverage, so a block holding rejected-draft KV is never
        matchable.  ``validate()`` holds after every step."""
        oob = self.pool.num_blocks * self.block_size
        bs = self.block_size
        # -- plan: draft grants from the leftover budget -------------------
        leftover = max(0, self.token_budget - int(n_new.sum()))
        k_of: Dict[int, int] = {}
        for i in decode_slots:
            if leftover <= 0:
                break
            req = self.slot_req[i]
            cl = int(self.cache_len[i])
            k = min(self.spec_k, self.chunk - 1, leftover,
                    self.max_len - 1 - cl,
                    req.max_new_tokens - len(req.out_tokens) - 1)
            if k <= 0:
                continue
            # grow the table without preempting (speculation is never
            # worth an eviction); k shrinks to the blocks obtained
            while int(self.slot_nblocks[i]) * bs < cl + 1 + k:
                bid = self._alloc_block()
                if bid is None:
                    break
                self.block_tables[i, self.slot_nblocks[i]] = bid
                self.slot_nblocks[i] += 1
            k = min(k, int(self.slot_nblocks[i]) * bs - cl - 1)
            if k <= 0:
                continue
            pos = cl + 1 + np.arange(k)
            blk = self.block_tables[i, pos // bs]
            slot_map[i, 1:1 + k] = blk * bs + pos % bs
            n_new[i] = 1 + k
            k_of[i] = k
            leftover -= k
        # -- sample-row operands: mask row j constrains emission j ---------
        sample_rows = decode_slots + [i for i in finishing
                                      if not self._skip_sample[i]]
        ids = np.zeros((self.slots, 3), np.int64)
        masks = np.full((self.slots, self.chunk, self.mask_width), -1,
                        np.int32)
        had_mask = np.zeros((self.slots, self.chunk), bool)
        for i in sample_rows:
            req = self.slot_req[i]
            ids[i] = (req.uid, req.sample_index, len(req.out_tokens))
            row = self._mask_row(req, req.out_tokens)
            if row is not None:
                masks[i, 0, :len(row)] = row
                had_mask[i, 0] = True
        # -- draft passes: pass j reads grid token j and proposes token
        # j + 1 under emission j's mask (a masked token is never proposed)
        for j in range(max(k_of.values(), default=0)):
            active = [i for i, k in k_of.items() if k > j]
            d_tok = np.zeros((self.slots, 1), np.int32)
            d_cl = np.zeros((self.slots,), np.int32)
            d_nn = np.zeros((self.slots,), np.int32)
            d_map = np.full((self.slots, 1), oob, np.int32)
            for i in active:
                d_tok[i, 0] = tokens[i, j]
                d_cl[i] = int(self.cache_len[i]) + j
                d_nn[i] = 1
                d_map[i, 0] = slot_map[i, j]
            toks_d, self.caches = self._draft_step(
                self.params, {"tokens": _host(d_tok)}, self.caches,
                _host(d_cl), _host(d_nn), _host(self.block_tables),
                _host(d_map), _host(masks[:, j]))
            d_host = toks_d.cpu().numpy()
            self.draft_d2h_fetches += 1
            for i in active:
                tokens[i, 1 + j] = int(d_host[i])
                req = self.slot_req[i]
                row = self._mask_row(req, list(req.out_tokens) + [
                    int(t) for t in tokens[i, 1:2 + j]])
                if row is not None:
                    masks[i, j + 1, :len(row)] = row
                    had_mask[i, j + 1] = True
        # -- verify: ONE mixed step over every slot's k + 1 positions, the
        # logits of the columns acceptance reads: emission j of a slot is
        # column start + j (a decode row starts at 0, a finishing prefill
        # at its last token) ----------------------------------------------
        start = np.zeros((self.slots,), np.int64)
        n_draft = np.zeros((self.slots,), np.int64)
        for i in range(self.slots):
            if i in decode_slots:
                n_draft[i] = k_of.get(i, 0)
            elif n_new[i]:
                start[i] = int(n_new[i]) - 1
        n_pos = int(n_draft.max()) + 1
        at = np.minimum(start[:, None] + np.arange(n_pos + 1),
                        self.chunk - 1)
        cols = _host(at[:, :n_pos])
        if self.packed:
            flat, seg, pos, nn_, smap, row_idx, bucket = \
                self._flatten_spec_grid(tokens, n_new, slot_map)
            lg, self.caches = self._spec_step(
                self.params, {"tokens": _host(flat)}, self.caches,
                _host(pos), _host(nn_), _host(seg), _host(self.block_tables),
                _host(smap), _host(row_idx), cols)
            self.grid_tokens += bucket
        else:
            lg, self.caches = self._spec_step(
                self.params, {"tokens": _host(tokens)}, self.caches,
                _host(self.cache_len), _host(n_new),
                _host(self.block_tables), _host(slot_map), cols)
            self.grid_tokens += self.slots * self.chunk
        emitted, n_emit = self._accept(
            lg, _host(np.take_along_axis(tokens, at, 1)),
            _host(np.zeros_like(start)), _host(n_draft), self._base_key,
            ids, _host(masks))
        got = torch.cat([emitted, n_emit[:, None]], dim=1).cpu().numpy()
        self.d2h_fetches += 1
        emitted, n_emit = got[:, :-1], got[:, -1]
        # -- host bookkeeping: prefill rows as in the plain step -----------
        old_len = self.cache_len.copy()
        self.scheduled_tokens += int(n_new.sum())
        self._last_slot_map = np.where(
            np.arange(self.chunk)[None, :] < n_new[:, None], slot_map, -1)
        for i in range(self.slots):
            t = int(n_new[i])
            if not t or i in decode_slots:
                continue
            self.cache_len[i] += t
            self.slot_fill[i] += t
            self.scheduled_prefill_tokens += t
            self.slot_hist[i].extend(int(x) for x in tokens[i, :t])
            if self.prefix_reuse:
                self._register_completed(i, int(old_len[i]),
                                         int(old_len[i]) + t)
        # -- decode rows: acceptance, rollback, emission -------------------
        for i in decode_slots:
            req = self.slot_req[i]
            k = k_of.get(i, 0)
            a = int(n_emit[i]) - 1
            if not 0 <= a <= k:
                raise AssertionError(f"slot {i}: accepted {a} of {k} drafts")
            self.draft_tokens += k
            self.accepted_tokens += a
            self.rejected_tokens += k - a
            if k and a == k:
                self.bonus_tokens += 1
            new_cl = int(old_len[i]) + 1 + a
            self.cache_len[i] = new_cl
            self.slot_hist[i].append(int(tokens[i, 0]))
            self.slot_hist[i].extend(int(emitted[i, j]) for j in range(a))
            # rollback: release the blocks past the accepted coverage
            need = -(-new_cl // bs)
            while int(self.slot_nblocks[i]) > need:
                nb = int(self.slot_nblocks[i]) - 1
                self.pool.decref(int(self.block_tables[i, nb]))
                self.block_tables[i, nb] = -1
                self.slot_nblocks[i] = nb
            if self.prefix_reuse:
                self._register_completed(i, int(old_len[i]), new_cl)
            for j in range(a + 1):
                if had_mask[i, j]:
                    self.masked_tokens += 1
                req.out_tokens.append(int(emitted[i, j]))
                req.token_steps.append(this_step)
            self._finish_check(i)
        for i in finishing:
            if self._skip_sample[i]:
                self._skip_sample[i] = False
                continue
            req = self.slot_req[i]
            if had_mask[i, 0]:
                self.masked_tokens += 1
            req.out_tokens.append(int(emitted[i, 0]))
            req.token_steps.append(this_step)
            self._finish_check(i)

    def _flatten_spec_grid(self, tokens: np.ndarray, n_new: np.ndarray,
                           slot_map: np.ndarray):
        """``_flatten_grid`` plus the (slots, chunk) map of flat rows the
        packed verify step gathers its logits through (rows past a
        slot's ``n_new`` point at flat row 0 and are never read)."""
        flat, seg, pos, nn_, smap, _, bucket = \
            self._flatten_grid(tokens, n_new, slot_map)
        row_idx = np.zeros((self.slots, self.chunk), np.int32)
        t = 0
        for i in range(self.slots):
            k = int(n_new[i])
            if k:
                row_idx[i, :k] = t + np.arange(k)
                t += k
        return flat, seg, pos, nn_, smap, row_idx, bucket

    def _sample_inputs(self, sample_rows: List[int]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """The sampler's host operands: per-slot stream coordinates
        (uid, sample_index, token_index) and the compact mask rows
        (-1-padded allowed ids; all -1: unconstrained).  Rows that emit
        nothing this step keep zeros / -1; their output is never read."""
        ids = np.zeros((self.slots, 3), np.int64)
        mask = np.full((self.slots, self.mask_width), -1, np.int32)
        for i in sample_rows:
            req = self.slot_req[i]
            ids[i] = (req.uid, req.sample_index, len(req.out_tokens))
            allowed = self._mask_row(req, req.out_tokens)
            if allowed is None:
                continue
            mask[i, :len(allowed)] = allowed
            self.masked_tokens += 1
        return ids, mask

    def _mask_row(self, req: Request,
                  out_prefix: Sequence[int]) -> Optional[List[int]]:
        """The validated allowed ids of the position after ``out_prefix``
        (None: unconstrained).  The speculative path asks with draft-
        extended prefixes, so masks constrain proposals and emissions
        alike."""
        if req.allowed_tokens is None:
            return None
        allowed = req.allowed_tokens(list(out_prefix))
        if allowed is None:
            return None
        allowed = list(allowed)
        if not allowed:
            raise ValueError(
                f"allowed_tokens for uid={req.uid} returned an empty set at "
                f"position {len(out_prefix)} — every continuation is "
                f"forbidden; return None for an unconstrained position")
        if len(allowed) > self.mask_width:
            raise ValueError(
                f"allowed_tokens returned {len(allowed)} ids > mask_width="
                f"{self.mask_width}; construct the engine with a larger "
                f"mask_width")
        return allowed

    # -- beam search (host bookkeeping over the copy-on-write fork) ---------

    def _beam_decode(self, beam_slots: List[int], cand_ids: np.ndarray,
                     cand_lps: np.ndarray, this_step: int):
        """Advance every beam hypothesis that decoded this step.  A group
        whose live siblings are all present expands jointly
        (``_beam_expand``); a partially present one (siblings queued,
        prefilling or preempted) extends each member by its own best
        token until the group is whole again."""
        by_uid: Dict[int, List[int]] = {}
        for i in beam_slots:
            by_uid.setdefault(self.slot_req[i].uid, []).append(i)
        for uid, slots_ in by_uid.items():
            group = self._beam_groups.get(uid)
            live = [k for k in (group or []) if not k.done]
            synced = group is not None and live and all(
                any(self.slot_req[s] is k for s in slots_) for k in live)
            if synced:
                self._beam_expand(sorted(slots_), cand_ids, cand_lps,
                                  this_step)
            else:
                self._beam_self_extend(slots_, cand_ids, cand_lps,
                                       this_step)

    def _beam_self_extend(self, slots_: List[int], cand_ids: np.ndarray,
                          cand_lps: np.ndarray, this_step: int):
        """Each present hypothesis takes its own top-1 continuation."""
        for i in slots_:
            req = self.slot_req[i]
            req.out_tokens.append(int(cand_ids[i, 0]))
            req.cum_logprob += float(cand_lps[i, 0])
            req.token_steps.append(this_step)
            self._finish_check(i)

    def _beam_expand(self, slots_: List[int], cand_ids: np.ndarray,
                     cand_lps: np.ndarray, this_step: int):
        """Joint expansion: rank the union of every live hypothesis' top-n
        continuations by cumulative log-prob (deduplicated by (history,
        token)) and reassign the group's slots to the winners.  A winner
        adopting another slot's hypothesis re-references its full blocks
        (``incref_all``) and copies only its partial tail block, before
        either writes again."""
        k = len(slots_)
        bs = self.block_size
        snap = {}
        for i in slots_:
            req = self.slot_req[i]
            snap[i] = {"out": list(req.out_tokens),
                       "steps": list(req.token_steps),
                       "hist": list(self.slot_hist[i]),
                       "chain": list(self.slot_chain[i]),
                       "cl": int(self.cache_len[i]),
                       "table": self.block_tables[i].copy(),
                       "nb": int(self.slot_nblocks[i])}
        best: Dict[tuple, tuple] = {}
        for i in slots_:
            req = self.slot_req[i]
            for j in range(req.n):
                score = req.cum_logprob + float(cand_lps[i, j])
                sig = (tuple(req.out_tokens), int(cand_ids[i, j]))
                cur = best.get(sig)
                if cur is None or score > cur[0] or \
                        (score == cur[0] and (i, j) < (cur[1], cur[2])):
                    best[sig] = (score, i, j, int(cand_ids[i, j]))
        ranked = sorted(best.values(),
                        key=lambda c: (-c[0], c[1], c[2]))[:k]
        if len(ranked) != k:
            raise AssertionError(f"beam: {len(ranked)} candidates for {k} "
                                 f"hypotheses")
        need = sum(1 for (_, p, _, _), c in zip(ranked, slots_)
                   if p != c and snap[p]["cl"] % bs)
        if self.pool.blocks_free < need:
            # no spare blocks for the tail copies: never preempt for an
            # optimization, extend each hypothesis by itself instead
            self._beam_self_extend(slots_, cand_ids, cand_lps, this_step)
            return
        # phase 1: every winner's table, while every parent still holds
        # its references (a parent losing its slot may be another
        # winner's ancestor)
        new_tables: Dict[int, Tuple[np.ndarray, int]] = {}
        for (_, p, _, _), c in zip(ranked, slots_):
            if p == c:
                continue
            nfull = snap[p]["cl"] // bs
            table = np.full((self.max_blocks,), -1, np.int32)
            table[:nfull] = snap[p]["table"][:nfull]
            self.pool.incref_all([int(b) for b in table[:nfull]])
            nb = nfull
            if snap[p]["cl"] % bs:
                dst = self._alloc_block()
                self.caches = copy_kv_block(self.caches,
                                            int(snap[p]["table"][nfull]),
                                            dst)
                table[nfull] = dst
                nb += 1
            new_tables[c] = (table, nb)
            self.beam_forks += 1
        # phase 2: release the losers' references, install the winners
        for (score, p, _, tok), c in zip(ranked, slots_):
            if c in new_tables:
                for jb in range(snap[c]["nb"]):
                    self.pool.decref(int(snap[c]["table"][jb]))
                table, nb = new_tables[c]
                self.block_tables[c] = table
                self.slot_nblocks[c] = nb
                self.cache_len[c] = snap[p]["cl"]
                self.slot_hist[c] = list(snap[p]["hist"])
                self.slot_chain[c] = list(snap[p]["chain"])
            req = self.slot_req[c]
            req.out_tokens = snap[p]["out"] + [tok]
            req.token_steps = snap[p]["steps"] + [this_step]
            req.cum_logprob = score
        for c in slots_:
            self._finish_check(c)

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
            "sibling_requests": self.sibling_requests,
            "beam_forks": self.beam_forks,
            "masked_tokens": self.masked_tokens,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "rejected_tokens": self.rejected_tokens,
            "bonus_tokens": self.bonus_tokens,
            "draft_d2h_fetches": self.draft_d2h_fetches,
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
        queued = {(r.uid, r.sample_index) for r in self.queue}
        active = {(self.slot_req[i].uid, self.slot_req[i].sample_index)
                  for i in self._active_slots()}
        for key in self._resume:
            assert key in queued and key not in active, key

"""The dense decoder transformer (attention + MLP blocks).

The reference stacks params over layer periods and scans over them;
here ``params["layers"]`` is a list of per-layer dicts and the depth
loop is a Python loop.  Layer l of the reference's period stack is
``layers[period * len(layout) + j]``.

Params tree::

    {"embed": {"table"}, "layers": [{"ln1", "q", "k", "v", "o", "ln2",
     "ffn": {"gate", "up", "down"}}, ...], "final_norm", "lm_head"}

Modes: 'prefill' (contiguous caches from position 0), 'decode' (one
token per slot) and 'mixed' (the serving engine's unified step: S
tokens per slot at per-slot ``cache_len`` offsets, the first
``n_new[b]`` real).  Mixed mode with ``seg_ids`` is the token-packed
layout: B = T tokens, S = 1, ``cache_len``/``n_new`` per token (its
position, 1 or 0) and ``seg_ids`` each token's slot.  With ``block_tables``/``slot_map`` the KV caches
are a global block pool (``init_paged_caches``).  Caches are updated
in place (and also returned, as the reference returns new caches).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as attn
from repro_torch.nn.basic import (apply_rope, embedding_apply,
                                  layernorm_apply, layernorm_init,
                                  rmsnorm_apply, rmsnorm_init)
from repro_torch.nn.linear import (dense_apply, ternarize_dense_params,
                                   ternary_dense_apply)
from repro_torch.nn.mlp import mlp_apply

Params = Dict[str, Any]
MODES = ("prefill", "decode", "mixed")


def _check_dense(cfg: ArchConfig):
    if (cfg.family != "dense" or cfg.moe is not None or cfg.mamba is not None
            or cfg.n_media_tokens or cfg.frontend_dim or cfg.tie_embeddings
            or any(b.mixer != "attn" or b.ffn != "mlp" for b in cfg.layout)):
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention+MLP family is ported")


def _norm_init(cfg: ArchConfig, d: int, device):
    return rmsnorm_init(d, cfg.pdtype, device) if cfg.norm == "rms" \
        else layernorm_init(d, cfg.pdtype, device)


def _norm_apply(cfg: ArchConfig, p, x):
    return rmsnorm_apply(p, x) if cfg.norm == "rms" \
        else layernorm_apply(p, x)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))


def _trunc_normal(shape, std: float, gen: torch.Generator, device,
                  dtype=torch.float32) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2], by inverse-CDF sampling."""
    u = torch.rand(shape, generator=gen, device=device)
    u = u * (_CDF_HI - _CDF_LO) + _CDF_LO
    x = torch.erfinv(u * 2.0 - 1.0) * _SQRT2
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


def _dense(d_in: int, d_out: int, cfg: ArchConfig, gen, device):
    return {"w": _trunc_normal((d_in, d_out), d_in ** -0.5, gen, device,
                               cfg.pdtype)}


def init(cfg: ArchConfig, seed: int = 0, device="cuda",
         ternarize: bool = False) -> Params:
    """Random master params from ``seed`` (a torch Generator on the
    device), made layer by layer.  ``ternarize=True`` converts each
    projection to serving codes as soon as it is made, so full-width fp32
    masters never coexist (28 chatglm3 layers would take ~23 GB).

    The numbers differ from the reference's ``jax.random`` init; parity
    tests convert the reference's params (``interop.params_from_numpy``).
    """
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd = cfg.d_model, cfg.hd
    pol = cfg.ternary

    def proj(d_in, d_out):
        p = _dense(d_in, d_out, cfg, gen, dev)
        return ternarize_dense_params(p, pol) if ternarize else p

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": _norm_init(cfg, d, dev),
            "q": proj(d, cfg.n_heads * hd),
            "k": proj(d, cfg.n_kv_heads * hd),
            "v": proj(d, cfg.n_kv_heads * hd),
            "o": proj(cfg.n_heads * hd, d),
            "ln2": _norm_init(cfg, d, dev),
            "ffn": {"gate": proj(d, cfg.d_ff), "up": proj(d, cfg.d_ff),
                    "down": proj(cfg.d_ff, d)},
        })
    return {
        "embed": {"table": _trunc_normal((cfg.vocab_padded, d), 0.02, gen,
                                         dev, cfg.pdtype)},
        "layers": layers,
        "final_norm": _norm_init(cfg, d, dev),
        "lm_head": _dense(d, cfg.vocab_padded, cfg, gen, dev),
    }


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _kv_cache(cfg: ArchConfig, lead: Tuple[int, int], device):
    hd, hk = cfg.hd, cfg.n_kv_heads
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(lead + (hk, hd), dtype=torch.int8,
                             device=device),
            "v": torch.zeros(lead + (hk, hd), dtype=torch.int8,
                             device=device),
            "k_scale": torch.zeros(lead + (hk,), dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(lead + (hk,), dtype=torch.bfloat16,
                                   device=device),
        }
    return {"k": torch.zeros(lead + (hk, hd), dtype=torch.bfloat16,
                             device=device),
            "v": torch.zeros(lead + (hk, hd), dtype=torch.bfloat16,
                             device=device)}


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Per-layer contiguous (batch, max_len, Hk, D) KV caches."""
    dev = resolve_device(device)
    return [_kv_cache(cfg, (batch, max_len), dev)
            for _ in range(cfg.n_layers)]


def init_paged_caches(cfg: ArchConfig, batch: int, num_blocks: int,
                      block_size: int, device="cuda"
                      ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer global (num_blocks, block_size, Hk, D) KV pools shared by
    every slot (``batch`` is kept for the reference's signature)."""
    dev = resolve_device(device)
    return [_kv_cache(cfg, (num_blocks, block_size), dev)
            for _ in range(cfg.n_layers)]


def _kv_quantize(t: torch.Tensor):
    """Per-(token, head) int8 quantization: t (..., Hk, D) -> (codes
    int8, scale bf16 (..., Hk))."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    codes = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(torch.bfloat16)


def _write_index(pool_shape, b: int, s: int, cache_len, n_new, slot_map,
                 seg_ids=None):
    """(source rows of the (B*S) token grid, destination flat cache
    positions) of the tokens that write.  Padding columns (col >=
    n_new) and out-of-capacity positions are dropped, as the reference's
    ``mode="drop"`` scatter drops them: a padding column must never
    write into the shared pool.  Token-packed contiguous caches write
    row ``seg_ids[t]`` instead of row t.  Computed on the device of the
    inputs (host tensors keep the scheduler free of device syncs)."""
    dev = cache_len.device
    col = torch.arange(s, device=dev)[None, :]
    nn_ = torch.full((b,), s, device=dev) if n_new is None \
        else n_new.to(dev)
    if slot_map is not None:
        cap = pool_shape[0] * pool_shape[1]
        pos = slot_map.to(dev).long()
    else:
        nrows, smax = pool_shape[0], pool_shape[1]
        cap = nrows * smax
        row = cache_len.long()[:, None] + col
        rid = torch.arange(b, device=dev)[:, None] if seg_ids is None \
            else seg_ids.to(dev).long().clamp(0, nrows - 1)[:, None]
        pos = torch.where(row < smax, rid * smax + row,
                          torch.full_like(row, cap))
    widx = torch.where(col < nn_[:, None], pos,
                       torch.full_like(pos, cap)).reshape(-1)
    src = torch.nonzero((widx >= 0) & (widx < cap)).squeeze(1)
    return src, widx[src]


def _scatter_(pool: torch.Tensor, vals: torch.Tensor, src, dst):
    """In-place pool[flat dst] = vals[flat src] (cast to the pool dtype)."""
    flat = pool.view((-1,) + tuple(pool.shape[2:]))
    rows = vals.reshape((-1,) + tuple(vals.shape[2:]))[src]
    flat.index_copy_(0, dst, rows.to(pool.dtype))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn_block_apply(p, x, cfg: ArchConfig, positions, mode, cache,
                      attn_kw, write, attn_impl):
    b, s, _ = x.shape
    hd, h, hk = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    pol, cd = cfg.ternary, cfg.cdtype

    xin = _norm_apply(cfg, p["ln1"], x)
    q = ternary_dense_apply(p["q"], xin, pol, cd).reshape(b, s, h, hd)
    k = ternary_dense_apply(p["k"], xin, pol, cd).reshape(b, s, hk, hd)
    v = ternary_dense_apply(p["v"], xin, pol, cd).reshape(b, s, hk, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_variant)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_variant)
    quant = cfg.kv_cache_dtype == "int8"

    if mode == "prefill":
        o = attn.chunked_attention(q, k, v, causal=not cfg.encoder_only,
                                   chunk_kv=cfg.attn_chunk_kv)
        if quant:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            cache["k"][:, :s] = kq
            cache["v"][:, :s] = vq
            cache["k_scale"][:, :s] = ks
            cache["v_scale"][:, :s] = vs
        else:
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
    else:
        src, dst = write
        scale_kw = {}
        if quant:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            _scatter_(cache["k"], kq, src, dst)
            _scatter_(cache["v"], vq, src, dst)
            _scatter_(cache["k_scale"], ks, src, dst)
            _scatter_(cache["v_scale"], vs, src, dst)
            if attn_kw["block_tables"] is not None:
                kd, vd = cache["k"], cache["v"]
                scale_kw = dict(k_scale=cache["k_scale"],
                                v_scale=cache["v_scale"])
            else:
                kd = attn.kv_dequantize(cache["k"], cache["k_scale"], cd)
                vd = attn.kv_dequantize(cache["v"], cache["v_scale"], cd)
        else:
            _scatter_(cache["k"], k, src, dst)
            _scatter_(cache["v"], v, src, dst)
            kd, vd = cache["k"], cache["v"]
        fn = attn.packed_mixed_attention if "seg_ids" in attn_kw \
            else attn.mixed_attention
        o = fn(q, kd, vd, chunk_kv=cfg.attn_chunk_kv, impl=attn_impl,
               **attn_kw, **scale_kw)

    o = ternary_dense_apply(p["o"], o.reshape(b, s, h * hd), pol, cd)
    return x + o.to(x.dtype)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            mode: str = "prefill",
            caches: Optional[List[Dict[str, torch.Tensor]]] = None,
            cache_len: Optional[torch.Tensor] = None,
            n_new: Optional[torch.Tensor] = None,
            block_tables: Optional[torch.Tensor] = None,
            slot_map: Optional[torch.Tensor] = None,
            impl: Optional[str] = None,
            seg_ids: Optional[torch.Tensor] = None):
    """Returns (hidden (B, S, d), caches, aux 0.0).

    ``seg_ids`` (T,) selects the token-packed layout (mixed mode only):
    B = T single-token rows, ``cache_len``/``n_new`` per token, paged
    ``block_tables`` still per slot, ``slot_map`` (T, 1).

    ``cache_len``/``n_new``/``slot_map`` may live on the host: the
    write positions are resolved where they live and only the result
    moves to the device.  ``impl`` overrides the route of every kernel
    in the step ('auto' kernels on CUDA, 'torch' plain versions).
    """
    _check_dense(cfg)
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: the port serves "
                                  f"{MODES}")
    if caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    if seg_ids is not None and mode != "mixed":
        raise ValueError("seg_ids (token-packed) needs mode='mixed'")
    attn_impl = "auto"
    if impl is not None:
        cfg = cfg.replace(ternary=cfg.ternary.replace(impl=impl))
        attn_impl = "torch" if impl == "torch" else "auto"
    cd = cfg.cdtype
    x = embedding_apply(params["embed"], batch["tokens"], cd)
    dev = x.device
    b, s = x.shape[0], x.shape[1]
    ar = torch.arange(s, device=dev)[None, :]
    write, attn_kw = None, {}
    if mode == "prefill":
        positions = ar
    else:
        cl = cache_len.to(dev)
        positions = cl[:, None] + ar
        write = tuple(t.to(dev) for t in _write_index(
            caches[0]["k"].shape, b, s, cache_len, n_new, slot_map,
            seg_ids))
        nn_ = torch.full((b,), s, device=dev, dtype=cl.dtype) \
            if n_new is None else n_new.to(dev)
        attn_kw = dict(kv_valid_len=cl + nn_, q_offset=cl,
                       block_tables=None if block_tables is None
                       else block_tables.to(dev))
        if seg_ids is not None:
            attn_kw["seg_ids"] = seg_ids.to(dev)

    for lp, cache in zip(params["layers"], caches):
        x = _attn_block_apply(lp, x, cfg, positions, mode, cache, attn_kw,
                              write, attn_impl)
        h_in = _norm_apply(cfg, lp["ln2"], x)
        y = mlp_apply(lp["ffn"], h_in, cfg.ternary, cfg.mlp_kind, cd)
        x = x + y.to(x.dtype)

    x = _norm_apply(cfg, params["final_norm"], x)
    return x, caches, torch.zeros((), dtype=torch.float32, device=dev)


def logits(params: Params, cfg: ArchConfig, hidden: torch.Tensor
           ) -> torch.Tensor:
    out = dense_apply(params["lm_head"], hidden, cfg.cdtype)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=out.device) \
            >= cfg.vocab_size
        out = out.masked_fill(pad, -1e30)
    return out

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py            # build, kernel phases, engine runs

Phases (any failure exits non-zero; nothing is caught):

1. card: ``nvidia-smi --query-gpu=name,power.limit`` line;
2. build: every ``csrc/*.cu`` compiled by ``nvcc`` (in parallel);
3. one phase per ported kernel at the main path's shapes (M = 8 slots
   x 16 tokens = 128 rows; K/N of chatglm3-6b's projections; paged
   attention at B=8, Sq=16, H=32, Hk=2, D=128, 128 table entries),
   each held against its plain PyTorch version (TiM: bit for bit;
   attention: |diff| <= 2^-7 |ref| + 2e-3), timed with CUDA events
   beside the plain version, the work's bound on the card and, where
   one PyTorch call computes the same function, that call;
4. engine runs: chatglm3-6b at full width (random weights from
   ``--seed``) served through ``ServeEngine`` under four ternary
   policies, each with every launch counter set to 0 before the run and
   read after it; the first step's logits of the kernel route are
   compared with the plain route's (relative L2 <= 0.5, argmax equal
   on >= 3/4 of the slots), and one step is traced with torch.profiler
   (device time by kernel beside the step's wall time);
5. the ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

It imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

TIM_SHAPES = [(4096, 4096), (4096, 256), (4096, 13696), (13696, 4096)]
TIM_KERNELS = {
    # name: (mode, packed, bits, need_t, replaces)
    "tim_single": ("single", False, 0, False,
                   "src/repro/kernels/tim_matmul.py:235"),
    "tim_single_packed": ("single", True, 0, False,
                          "src/repro/kernels/tim_matmul.py:295"),
    "tim_two_phase": ("phases", True, 0, True,
                      "src/repro/kernels/tim_matmul.py:413"),
    "tim_bitserial": ("bits", True, 4, False,
                      "src/repro/kernels/tim_matmul.py:507"),
}
ATTN_REPLACES = "src/repro/kernels/paged_attention.py:184"

# served policies: every TiM kernel sits on at least one served path
POLICIES = {
    "A": dict(encoding="symmetric", act_mode="int4", pack=True,
              kv="bfloat16"),
    "B": dict(encoding="symmetric", act_mode="ternary", pack=False,
              kv="bfloat16"),
    "C": dict(encoding="asymmetric", act_mode="ternary", pack=True,
              kv="int8"),
    "D": dict(encoding="symmetric", act_mode="ternary", pack=True,
              kv="bfloat16"),
}
POLICY_KERNELS = {"A": ["tim_bitserial"], "B": ["tim_single"],
                  "C": ["tim_two_phase"], "D": ["tim_single_packed"]}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, ops_rate: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# TiM matmul phases
# ---------------------------------------------------------------------------

def tim_inputs(m, k, n, mode, bits, gen):
    import torch
    from repro_torch.core.packing import pack2b
    dev = "cuda"
    if mode == "bits":
        x = torch.randint(0, 1 << bits, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        x = torch.randint(-1, 2, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
    w = torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    w1 = torch.rand(n, generator=gen, device=dev) * 0.05 + 0.01
    w2 = torch.rand(n, generator=gen, device=dev) * 0.05 + 0.01
    iscale = torch.tensor([1.0, 1.0] if mode == "phases" else [1.0 / 15],
                          device=dev, dtype=torch.float32)
    if mode == "bits":
        iscale = iscale.to(torch.bfloat16).float()   # the int4 step
    return x, w, pack2b(w, axis=0), w1, w2, iscale


def tim_phase(name, spec, gen, iters):
    import torch
    from repro_torch.kernels import tim_matmul as tk
    mode, packed, bits, need_t, _ = spec
    rows = []
    for (k, n), n_max in [(s, None) for s in TIM_SHAPES] + \
            [((4096, 4096), 8)]:
        m = 128
        x, w, wp, w1, w2, isc = tim_inputs(m, k, n, mode, bits, gen)
        wd = wp if packed else w
        kw = dict(mode=mode, packed=packed, need_t=need_t, n_max=n_max,
                  bits=bits, out_dtype=torch.bfloat16)
        out = tk.tim_st_launch(x, wd, w1, w2, isc, **kw)
        ref = tk.tim_st_plain(x, wd, w1, w2, isc, **kw)
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, ref))
        err = float((out.float() - ref.float()).abs().max())
        if not exact:
            raise AssertionError(f"{name} K={k} N={n} n_max={n_max}: "
                                 f"kernel != plain (max |diff| {err})")
        ms = time_ms(lambda: tk.tim_st_launch(x, wd, w1, w2, isc, **kw),
                     iters)
        plain_ms = time_ms(lambda: tk.tim_st_plain(x, wd, w1, w2, isc,
                                                   **kw), max(2, iters // 4))
        lib_ms = None
        if name == "tim_single" and n_max is None:
            lib_ms = time_ms(lambda: torch._int_mm(x, w), iters)
        t_eff = need_t or n_max is not None
        passes = {"single": 1, "phases": 2,
                  "bits": bits if n_max is not None else 1}[mode]
        ops = 2.0 * m * n * k * passes * (2 if t_eff else 1)
        nbytes = m * k + wd.numel() + 8 * n + 2 * m * n
        b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
        row = dict(K=k, N=n, n_max=n_max, bit_exact=exact, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        log(f"[kernel {name}] M={m} K={k} N={n} n_max={n_max} "
            f"bit_exact={exact} max_abs_err={err} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms} "
            f"bound_ms={b_ms:.5f} ({b_by})")
        rows.append(row)
        del x, w, wp, wd, out, ref
    return rows


# ---------------------------------------------------------------------------
# paged attention phase
# ---------------------------------------------------------------------------

def attn_inputs(gen, quant: bool):
    import torch
    from repro_torch.models.transformer import _kv_quantize
    b, sq, h, hk, d, bs, nblk = 8, 16, 32, 2, 128, 16, 128
    nb = b * (nblk + 1)
    dev = "cuda"
    q = torch.randn((b, sq, h, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn((nb, bs, hk, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn((nb, bs, hk, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    perm = torch.randperm(nb, generator=gen, device=dev)
    tables = perm[:b * nblk].reshape(b, nblk).to(torch.int32)
    # per-slot cache_len / n_new of a mixed step: long and short
    # prefixes, decodes, a just-admitted prompt and an empty slot
    cache_len = torch.tensor([2032, 1500, 700, 1023, 0, 1, 333, 0],
                             device=dev, dtype=torch.int32)
    n_new = torch.tensor([16, 1, 16, 1, 16, 16, 1, 0], device=dev,
                         dtype=torch.int32)
    kw = {}
    if quant:
        k, ks = _kv_quantize(k)
        v, vs = _kv_quantize(v)
        kw = dict(k_scale=ks, v_scale=vs)
    return q, k, v, tables, cache_len + n_new, cache_len, kw


def attn_phase(gen, iters):
    import torch
    from repro_torch.kernels import paged_attention as pk
    rows = []
    for label, quant, causal in [("bf16 causal", False, True),
                                 ("int8 causal", True, True),
                                 ("bf16 causal=False", False, False)]:
        q, k, v, tbl, vlen, qoff, kw = attn_inputs(gen, quant)
        args = (q, k, v, tbl, vlen)
        out = pk.paged_attention_launch(*args, q_offset=qoff, causal=causal,
                                        **kw)
        ref = pk.paged_attention_plain(*args, q_offset=qoff, chunk_kv=1024,
                                       causal=causal, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        tol = ref.float().abs() * 2.0 ** -7 + 2e-3
        err = float(diff.max())
        if not bool(torch.isfinite(out.float()).all()) or \
                bool((diff > tol).any()):
            raise AssertionError(f"paged_attention {label}: kernel vs plain "
                                 f"max |diff| {err} exceeds tolerance")
        ms = time_ms(lambda: pk.paged_attention_launch(
            *args, q_offset=qoff, causal=causal, **kw), iters)
        plain_ms = time_ms(lambda: pk.paged_attention_plain(
            *args, q_offset=qoff, chunk_kv=1024, causal=causal, **kw),
            max(2, iters // 4))
        lib_ms = attn_library_ms(q, k, v, tbl, vlen, qoff, kw, causal,
                                 iters) if not quant else None
        b, sq, h, d = q.shape
        hk, bs = k.shape[2], k.shape[1]
        pos_bytes = hk * d * k.element_size() * 2 + (hk * 4 if quant else 0)
        nbytes = 2 * q.numel() * 2 + tbl.numel() * 4
        pairs = 0
        for bi in range(b):
            vl, qo = int(vlen[bi]), int(qoff[bi])
            nbytes += -(-vl // bs) * bs * pos_bytes
            for qi in range(sq):
                pairs += min(vl, qo + qi + 1) if causal else vl
        ops = 4.0 * d * h * pairs          # QK^T and PV, 2 flops each
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS_PER_S)
        log(f"[kernel paged_attention {label}] B={b} Sq={sq} H={h} Hk={hk} "
            f"D={d} nblk={tbl.shape[1]} max_abs_err={err} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms} "
            f"bound_ms={b_ms:.5f} ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def attn_library_ms(q, k, v, tbl, vlen, qoff, kw, causal, iters):
    """scaled_dot_product_attention on the pre-gathered K/V (the gather
    itself is not timed) with the same causal + validity mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.nn.attention import paged_view
    b, sq, h, d = q.shape
    hk = k.shape[2]
    kg = paged_view(k, tbl).repeat_interleave(h // hk, dim=2)
    vg = paged_view(v, tbl).repeat_interleave(h // hk, dim=2)
    sk = kg.shape[1]
    kpos = torch.arange(sk, device=q.device)
    qpos = qoff[:, None] + torch.arange(sq, device=q.device)[None]
    mask = kpos[None, None, :] < vlen[:, None, None]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    mask = mask[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kg, vg))
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), iters)


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

def make_requests(vocab: int, seed: int, n: int = 12):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256).astype(np.int32)
    prompts = []
    for uid in range(n):
        prompts.append(rng.integers(0, vocab, int(rng.integers(64, 513))
                                    ).astype(np.int32))
    # 4 of 12 share a 256-token prefix: uid 0 is admitted first, uids 8
    # and 10 arrive once its blocks are resident (full-block hits), and
    # uid 11 is the bare prefix: a whole-prompt hit, whose last block is
    # copied (copy-on-write) so its final position can be recomputed
    for uid in (0, 8, 10):
        tail = rng.integers(0, vocab, int(rng.integers(33, 97)))
        prompts[uid] = np.concatenate([prefix, tail.astype(np.int32)])
    prompts[11] = prefix.copy()
    return [Request(uid, p, 16) for uid, p in enumerate(prompts[:n])]


def first_step(params, cfg, seed, impl):
    """One unified step (8 slots x 16 prompt tokens, 2048-token tables)
    on fresh caches; returns its logits."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import make_paged_unified_step
    slots, chunk, bs, max_len = 8, 16, 16, 2048
    nblk = max_len // bs
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (slots, chunk), generator=gen,
                           dtype=torch.int32)
    tables = torch.arange(slots * nblk, dtype=torch.int32).reshape(slots,
                                                                  nblk)
    slot_map = (tables[:, :1] * bs + torch.arange(chunk)).to(torch.int32)
    caches = tfm.init_paged_caches(cfg, slots, slots * (nblk + 1), bs,
                                   "cuda")
    lg, _ = make_paged_unified_step(cfg, impl)(
        params, {"tokens": tokens}, caches,
        torch.zeros(slots, dtype=torch.int32),
        torch.full((slots,), chunk, dtype=torch.int32), tables, slot_map)
    return lg.float()


def profile_step(params, cfg, seed, label):
    """Device time of one unified step by kernel name, beside the step's
    host wall time (torch.profiler; a trace without device events is
    reported as not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    first_step(params, cfg, seed, "auto")            # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        first_step(params, cfg, seed, "auto")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): an aten op also
        # reports the device time of the kernels it launched
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile {label}] one step: wall_ms={wall_ms:.2f} "
        + (f"device_busy_ms={busy:.2f} busy_share={busy / wall_ms:.3f} "
           f"top=" + "; ".join(f"{k[:60]}={v:.2f}ms" for k, v in top)
           if by_name else "device time not measured (no device events)"))


def engine_run(label, pol, layers, seed):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine
    base = get_config("chatglm3-6b")
    cfg = base.replace(
        n_layers=layers, kv_cache_dtype=pol["kv"],
        ternary=base.ternary.replace(encoding=pol["encoding"],
                                     act_mode=pol["act_mode"],
                                     pack=pol["pack"]))
    t0 = time.perf_counter()
    params = tfm.init(cfg, seed=seed, device="cuda", ternarize=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    lg_k = first_step(params, cfg, seed, "auto")
    lg_p = first_step(params, cfg, seed, "torch")
    if not bool(torch.isfinite(lg_k[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"policy {label}: non-finite logits")
    real = slice(0, cfg.vocab_size)
    d = (lg_k[:, real] - lg_p[:, real])
    rel = float(d.norm() / lg_p[:, real].norm())
    agree = float((lg_k[:, real].argmax(-1) == lg_p[:, real].argmax(-1)
                   ).float().mean())
    log(f"[engine {label}] first-step logits kernel vs plain: rel_l2="
        f"{rel:.3e} max_abs={float(d.abs().max()):.4f} "
        f"argmax_agree={agree:.3f}")
    # The TiM kernels equal their plain versions bit for bit and paged
    # attention agrees to ~1 bf16 ulp (kernel phases above); through
    # 28 layers of ternary/int4 activation quantization such an ulp can
    # flip codes, so the two routes' logits part by a relative L2 of up
    # to ~0.15 (0.139 seen under policy C on the H100).  A kernel
    # computing a different function lands near 1.
    if rel > 0.5 or agree < 0.75:
        raise AssertionError(f"policy {label}: first-step logits of the "
                             f"kernel route differ from the plain route "
                             f"(relative L2 {rel:.3e} > 0.5 or argmax "
                             f"agreement {agree:.3f} < 0.75)")

    profile_step(params, cfg, seed, label)

    eng = ServeEngine(params, cfg, batch_slots=8, max_len=2048, chunk=16,
                      block_size=16, token_budget=128, device="cuda")
    reqs = make_requests(cfg.vocab_size, seed)
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = eng.stats()
    gen_tok = sum(len(r.out_tokens) for r in done)
    if len(done) != len(reqs) or any(not r.done for r in reqs):
        raise AssertionError(f"policy {label}: not every request finished")
    if any(len(r.out_tokens) != 16 for r in reqs):
        raise AssertionError(f"policy {label}: short outputs")
    if any(not (0 <= t < cfg.vocab_size) for r in reqs
           for t in r.out_tokens):
        raise AssertionError(f"policy {label}: token outside the vocab")
    need = POLICY_KERNELS[label] + ["paged_attention"]
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"policy {label}: kernels never launched on "
                             f"the served path: {missing}")
    if st["prefix_hit_tokens"] <= 0 or st["cow_copies"] <= 0:
        raise AssertionError(f"policy {label}: prefix reuse / copy-on-write "
                             f"did not fire: {st}")
    log(f"[engine {label}] policy={pol} layers={layers} init_s={init_s:.2f} "
        f"steps={st['steps']} generated_tokens={gen_tok} "
        f"scheduled_tokens={st['scheduled_tokens']} "
        f"prefix_hit_tokens={st['prefix_hit_tokens']} "
        f"cow_copies={st['cow_copies']} wall_s={wall:.3f} "
        f"tokens_per_s={st['scheduled_tokens'] / wall:.1f} "
        f"generated_per_s={gen_tok / wall:.2f} launches={counts}")
    del eng, params
    torch.cuda.empty_cache()
    return counts, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=28,
                    help="depth of the served chatglm3-6b (full: 28)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s per-source {took}")
    for name in took:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    tim_rows = {n: tim_phase(n, s, gen, args.iters)
                for n, s in TIM_KERNELS.items()}
    attn_rows = attn_phase(gen, args.iters)

    launches = {n: 0 for n in list(TIM_KERNELS) + ["paged_attention"]}
    for label in POLICIES:
        counts, _ = engine_run(label, POLICIES[label], args.layers,
                               args.seed)
        for k in launches:
            launches[k] += counts[k]

    kernels = []
    for name, spec in TIM_KERNELS.items():
        r = next(x for x in tim_rows[name]
                 if (x["K"], x["N"]) == (4096, 13696))
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/tim_matmul.cu", replaces=spec[4],
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    a = attn_rows[0]
    kernels.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces=ATTN_REPLACES, launches=launches["paged_attention"],
        max_abs_err=max(x["max_abs_err"] for x in attn_rows), ms=a["ms"],
        plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"]))
    never = [k["name"] for k in kernels if k["launches"] <= 0]
    if never:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{never}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

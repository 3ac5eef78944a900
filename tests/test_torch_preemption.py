"""Port parity (preemption/swap): pools below the full-batch floor.

The port's ``ServeEngine`` on the CPU with an undersized pool must give
every request the tokens of a full-pool run (swap restores KV bit for
bit, recompute replays the same history), keep the pool invariants
after every step, and close the token accounting.  Against the
reference ``ServeEngine`` only host-side counters are compared (steps,
grid/scheduled tokens, preemptions, swaps, recompute): the reference
engine's tokens are not an oracle under this jax version (ROADMAP §3
R1).  The swap-vs-recompute crossover is held to the reference's with
the reference's chip constants passed in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (the reference engine's tests are timing-
# sensitive under this jax version, ROADMAP R1)
torch.set_num_threads(1)

from test_torch_model import build  # noqa: E402

from repro.serve import metrics as jmetrics  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sim.chip import HOST_LINK_BW, PEAK_FLOPS  # noqa: E402

from repro_torch.serve import metrics  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      fetch_kv_blocks, write_kv_blocks)

MAX_LEN, BS, SLOTS, CHUNK = 32, 8, 2, 8
FLOOR = MAX_LEN // BS + 1                 # one full sequence + a spare
MAX_NEW = [8, 4, 4]
POLICY = dict(encoding="symmetric", act_mode="ternary")
REF_CHIP = dict(peak_flops=PEAK_FLOPS, host_link_bw=HOST_LINK_BW)


def _model(kv="bfloat16"):
    return build("granite-34b", POLICY, kv)


def _prompts(vocab):
    """Slot 0's decode crosses a block boundary while two long prompts
    hold the pool (the decode-preempts-prefill trigger); the third
    request resumes from the queue."""
    rng = np.random.default_rng(5)
    return [rng.integers(1, vocab, n).astype(np.int32)
            for n in (14, 30, 27)]


def _run(cfg, params, prompts, max_new=MAX_NEW, **kw):
    eng = ServeEngine(params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk=CHUNK, block_size=BS, device="cpu", **kw)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new[uid]))
    it = 0
    while eng.queue or eng._active_slots():
        eng.step()
        eng.validate()
        it += 1
        assert it < 400, "no progress"
    return eng, {r.uid: list(r.out_tokens) for r in eng.finished}


_FULL = {}


def _full_pool(kv="bfloat16"):
    if kv not in _FULL:
        _, _, cfg, tp = _model(kv)
        eng, toks = _run(cfg, tp, _prompts(cfg.vocab_size))
        assert eng.stats()["preemptions"] == 0
        _FULL[kv] = toks
    return _FULL[kv]


# swap runs with prefix reuse off, so the resume MUST read the arena
# (with reuse on, still-resident blocks re-attach by hash first)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("preempt,reuse", [("recompute", True),
                                           ("swap", False),
                                           ("auto", True)])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_small_pool_tokens_match_full_pool(kv, preempt, reuse, packed):
    _, _, cfg, tp = _model(kv)
    eng, got = _run(cfg, tp, _prompts(cfg.vocab_size), num_blocks=FLOOR,
                    preempt=preempt, prefix_reuse=reuse, packed=packed)
    st = eng.stats()
    assert st["preemptions"] > 0, "a pool at the hard floor must preempt"
    assert st["preemptable_pool"] == 1
    assert got == _full_pool(kv)
    assert all(r.done for r in eng.finished)
    assert st["blocks_in_use"] == 0 and st["preempted_waiting"] == 0
    assert st["scheduled_prefill_tokens"] + st["prefix_hit_tokens"] \
        + st["swapped_in_tokens"] == st["admitted_prompt_tokens"]
    if preempt == "swap":
        assert st["swapped_out_blocks"] > 0 and st["swapped_in_blocks"] > 0
        assert st["swap_d2h_fetches"] > 0
        assert eng.swap_d2h_bytes == st["swapped_out_blocks"] \
            * eng._block_bytes
    if preempt == "recompute":
        assert st["swapped_in_blocks"] == 0 and st["swap_d2h_fetches"] == 0
        assert st["recompute_tokens"] > 0


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_write_kv_blocks_restores_blocks_in_one_copy(kv):
    """Blocks fetched to the host go back, several at once and to other
    physical blocks, byte for byte (K, V and any int8 scales)."""
    _, _, cfg, tp = _model(kv)
    eng = ServeEngine(tp, cfg, batch_slots=1, max_len=MAX_LEN, chunk=CHUNK,
                      block_size=BS, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for layer in eng.caches:
        for t in layer.values():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
            else:
                t.copy_(torch.randn(t.shape, generator=gen))
    saved = fetch_kv_blocks(eng.caches, [1, 3])
    split = {}
    assert fetch_kv_blocks(eng.caches, [1], split) and not split  # CPU
    per_block = [{k: t[:, i] for k, t in saved.items()} for i in range(2)]
    assert write_kv_blocks(eng.caches, [], []) == 0
    n = write_kv_blocks(eng.caches, [4, 2], per_block)
    assert n == sum(t.numel() * t.element_size() for t in saved.values())
    back = fetch_kv_blocks(eng.caches, [4, 2])
    for key, t in saved.items():
        assert torch.equal(back[key], t)
    untouched = fetch_kv_blocks(eng.caches, [1, 3])
    for key, t in saved.items():
        assert torch.equal(untouched[key], t)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_swap_in_restores_kv_bytes(kv):
    """Swap a mid-prefill slot out, resume it, and compare the restored
    pool blocks (K, V and any int8 scales) with what was resident."""
    _, _, cfg, tp = _model(kv)
    prompt = _prompts(cfg.vocab_size)[1]
    eng = ServeEngine(tp, cfg, batch_slots=1, max_len=MAX_LEN, chunk=CHUNK,
                      block_size=BS, preempt="swap", prefix_reuse=False,
                      device="cpu")
    req = Request(0, prompt, 2)
    eng.submit(req)
    eng.step()
    eng.step()                       # 16 prompt tokens = 2 full blocks
    assert int(eng.cache_len[0]) == 16
    saved = fetch_kv_blocks(eng.caches, eng.block_tables[0, :2])
    assert set(saved) == ({"k", "v", "k_scale", "v_scale"} if kv == "int8"
                          else {"k", "v"})
    eng._preempt(0)
    eng.validate()
    arena = eng._resume[(req.uid, req.sample_index)]
    assert sorted(arena["swap"]) == [0, 1] and arena["covered"] == 16
    for jb in (0, 1):
        for key, t in saved.items():
            assert torch.equal(arena["swap"][jb][key], t[:, jb])
    eng.step()                       # re-admits and swaps back in
    st = eng.stats()
    assert st["swapped_in_blocks"] == 2 and st["recompute_tokens"] == 0
    assert eng.swap_h2d_copies == 1          # both blocks in one copy
    restored = fetch_kv_blocks(eng.caches, eng.block_tables[0, :2])
    for key, t in saved.items():
        assert torch.equal(restored[key], t)
    while eng.queue or eng._active_slots():
        eng.step()
        eng.validate()
    _, want = _run(cfg, tp, [prompt], max_new=[2])
    assert req.out_tokens == want[0]


@pytest.mark.parametrize("preempt", ["recompute", "swap"])
def test_preempt_mid_decode_resumes_exactly(preempt):
    """Preempt a decoding slot: the refill must not re-append its
    pending token, and the rollout continues token for token."""
    _, _, cfg, tp = _model()
    prompt = _prompts(cfg.vocab_size)[0]
    eng = ServeEngine(tp, cfg, batch_slots=1, max_len=MAX_LEN, chunk=CHUNK,
                      block_size=BS, preempt=preempt, device="cpu")
    req = Request(0, prompt, 6)
    eng.submit(req)
    for _ in range(4):               # prefill (2 steps) + 2 decodes
        eng.step()
    assert len(req.out_tokens) >= 2
    eng._preempt(0)
    eng.validate()
    while eng.queue or eng._active_slots():
        eng.step()
        eng.validate()
    _, want = _run(cfg, tp, [prompt], max_new=[6])
    assert req.out_tokens == want[0]
    assert eng.stats()["preemptions"] == 1


def test_preempt_none_livelock_raises():
    """preempt='none' at the hard floor, with a budget that lets both
    slots prefill full chunks: two 24-token prompts wedge each other and
    run_until_done raises instead of spinning."""
    _, _, cfg, tp = _model()
    eng = ServeEngine(tp, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk=CHUNK, block_size=BS, num_blocks=FLOOR,
                      preempt="none", token_budget=16, device="cpu")
    rng = np.random.default_rng(0)
    for uid in range(2):
        eng.submit(Request(uid, rng.integers(1, 100, 24).astype(np.int32),
                           4))
    with pytest.raises(RuntimeError, match="no progress") as err:
        eng.run_until_done(stall_iters=6)
    assert "preempt='none'" in str(err.value)
    assert eng.stats()["preemptions"] == 0


def test_pool_floors():
    _, _, cfg, tp = _model()
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, block_size=BS,
              device="cpu")
    with pytest.raises(ValueError, match="one full"):
        ServeEngine(tp, cfg, num_blocks=FLOOR - 1, **kw)
    with pytest.raises(ValueError, match="preempt"):
        ServeEngine(tp, cfg, preempt="sometimes", **kw)
    assert ServeEngine(tp, cfg, num_blocks=FLOOR, **kw).preemptable
    full = SLOTS * (MAX_LEN // BS) + 1
    assert not ServeEngine(tp, cfg, num_blocks=full, **kw).preemptable


def _reference_engine(jcfg, jp, **kw):
    return JServeEngine(jp, jcfg, batch_slots=SLOTS, max_len=MAX_LEN,
                        chunk=CHUNK, block_size=BS, **kw)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_crossover_matches_reference(kv):
    """With the reference's chip constants, the port counts the same
    parameters and block bytes and picks swap or recompute for every
    victim shape as the reference's formula does (faster host links
    sweep the smoke model across the crossover)."""
    jcfg, jp, cfg, tp = _model(kv)
    ref = _reference_engine(jcfg, jp, num_blocks=FLOOR)
    ours = ServeEngine(tp, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                       chunk=CHUNK, block_size=BS, num_blocks=FLOOR,
                       device="cpu", **REF_CHIP)
    assert ours._n_params == ref._n_params
    assert ours._block_bytes == ref._block_bytes
    seen = set()
    for scale in (1, 10, 100, 1000, 10000):
        ours.host_link_bw = HOST_LINK_BW * scale
        for n_own in range(1, MAX_LEN // BS + 1):
            for covered in range(1, n_own * BS + 1):
                t_re = 2.0 * ref._n_params * min(covered, n_own * BS) \
                    / PEAK_FLOPS
                t_sw = 2.0 * n_own * ref._block_bytes \
                    / (HOST_LINK_BW * scale)
                want = "swap" if t_sw < t_re else "recompute"
                assert ours._swap_or_recompute(covered, n_own) == want
                seen.add(want)
    assert seen == {"swap", "recompute"}       # the sweep crosses over


COUNTERS = ("steps", "scheduled_tokens", "grid_tokens", "preemptions",
            "swapped_out_blocks", "swapped_in_blocks", "recompute_tokens")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("preempt,reuse", [("swap", False),
                                           ("recompute", True),
                                           ("auto", True)])
def test_host_counters_match_reference_engine(preempt, reuse, packed):
    jcfg, jp, cfg, tp = _model()
    prompts = _prompts(cfg.vocab_size)
    kw = dict(num_blocks=FLOOR, preempt=preempt, prefix_reuse=reuse,
              packed=packed)
    ours, _ = _run(cfg, tp, prompts, **kw, **REF_CHIP)
    ref = _reference_engine(jcfg, jp, **kw)
    for uid, p in enumerate(prompts):
        ref.submit(JRequest(uid=uid, prompt=p, max_new_tokens=MAX_NEW[uid]))
    ref.run_until_done()
    a, b = ours.stats(), ref.stats()
    assert {k: a[k] for k in COUNTERS} == {k: b[k] for k in COUNTERS}
    assert a["preemptions"] > 0


@pytest.mark.parametrize("packed", [False, True])
def test_metrics_summarize_matches_reference(packed):
    """serve/metrics is a copy: on one small-pool run (per-step stats()
    snapshots) it gives the reference module's digest, padding
    efficiency included, and its counter registry covers every key the
    port's stats() emits."""
    _, _, cfg, tp = _model()
    eng = ServeEngine(tp, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk=CHUNK, block_size=BS, num_blocks=FLOOR,
                      packed=packed, device="cpu")
    for uid, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(uid, p, MAX_NEW[uid]))
    snaps = []
    while eng.queue or eng._active_slots():
        eng.step()
        snaps.append(eng.stats())
    ours = metrics.summarize(eng.finished, snaps, eng.iters)
    assert ours == jmetrics.summarize(eng.finished, snaps, eng.iters)
    assert 0 < ours["padding_efficiency"] <= 1
    assert ours["preemptions"] > 0
    deltas = metrics.counter_deltas(snaps)
    assert sum(d["scheduled_tokens"] for d in deltas) \
        == snaps[-1]["scheduled_tokens"]

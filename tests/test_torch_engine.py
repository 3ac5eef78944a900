"""Port parity (engine): ``repro_torch.serve.engine.ServeEngine`` on the
CPU against the reference's greedy oracle rollout
(``tests/_serve_ref.py``: unpadded whole-prompt prefill + one-token
decode), token for token — not against the reference ``ServeEngine``,
whose host buffers alias device memory under this jax version.

Plus the engine's own contracts: prefix reuse and copy-on-write fire,
pool/table invariants hold after every step, what a step reads never
aliases the scheduler's host arrays, what stays outside the port (media,
non-dense stacks, the QAT forward) raises NotImplementedError, and a
pool below the hard floor raises ValueError.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (the reference engine's tests are timing-
# sensitive under this jax version, ROADMAP R1)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _serve_ref import reference_rollout  # noqa: E402
from test_torch_model import build  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.engine import make_unified_step  # noqa: E402

from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

MAX_LEN, NEW = 64, 4

POLICIES = {
    "int4_packed": (dict(encoding="symmetric", act_mode="int4", pack=True),
                    "bfloat16"),
    "ternary_asym_int8kv": (dict(encoding="asymmetric", act_mode="ternary",
                                 pack=True), "int8"),
    "ternary_dense": (dict(encoding="symmetric", act_mode="ternary"),
                      "bfloat16"),
}


def _prompts(vocab, seed):
    """p0; an unrelated prompt; p0's first two blocks plus a new tail
    (full-block prefix hits once p0 has run); p0's first 32 tokens (a
    whole-prompt hit: its last block is served copy-on-write)."""
    rng = np.random.default_rng(seed)
    p0 = rng.integers(0, vocab, 37).astype(np.int32)
    other = rng.integers(0, vocab, 21).astype(np.int32)
    shared = np.concatenate([p0[:32], rng.integers(0, vocab, 7)
                             ]).astype(np.int32)
    return [p0, other, shared, p0[:32].copy()]


def _oracle_cfg(jcfg):
    """Two-phase layers of the oracle take the reference's per-phase-
    rounding route (``fused=False``: each phase rounded to bf16 before
    the subtraction) — the Pallas kernel's arithmetic, which the port
    implements; the reference's CPU default (one f32 subtraction) rounds
    differently, and ternary activations amplify that into other
    tokens."""
    if jcfg.ternary.encoding == "asymmetric":
        return jcfg.replace(ternary=jcfg.ternary.replace(fused=False))
    return jcfg


def _serve(cfg, params, prompts, **kw):
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=MAX_LEN, chunk=8,
                      device="cpu", **kw)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, NEW))
    while eng.queue or eng._active_slots():
        eng.step()
        eng.validate()
    return eng, {r.uid: r.out_tokens for r in eng.finished}


_STEP_FNS = {}


def _near_tie(jcfg) -> float:
    """Logit margin below which cross-framework rounding may decide the
    race: 2^-5 for ternary activations; 2^-3 for int4, whose 15-level
    codes flip on a one-ulp change several times more often (one-block
    logit differences of up to 0.125 seen, test_torch_model.py)."""
    return 2.0 ** -3 if jcfg.ternary.act_bits else 2.0 ** -5


def _agree_until_near_tie(got, ref, margins, near_tie) -> int:
    """Assert got == ref up to the first position where the reference
    decided a near-tie; return how many tokens were compared."""
    for j, (a, b, m) in enumerate(zip(got, ref, margins)):
        if m < near_tie:
            return j + (a == b)
        assert a == b, (j, got, ref, margins)
    return len(ref)


def chunked_oracle(jp, jcfg, prompt, steps):
    """The reference model served the engine's way: the prompt streams
    through the reference's unified mixed step in chunks of 8 (so an
    int8 KV cache is read back quantized, as the engine reads it), then
    one-token decodes.  Returns (tokens, top-2 logit margin per token)."""
    key = jcfg
    if key not in _STEP_FNS:
        _STEP_FNS[key] = jax.jit(make_unified_step(jcfg))
    step = _STEP_FNS[key]
    caches = jtfm.init_caches(jcfg, 1, MAX_LEN)
    toks, margins, pos, chunk = [], [], 0, 8
    feed = list(prompt)
    while len(toks) < steps:
        take = feed[:chunk]
        feed = feed[chunk:]
        grid = np.zeros((1, chunk), np.int32)
        grid[0, :len(take)] = take
        lg, caches = step(jp, {"tokens": jnp.asarray(grid)}, caches,
                          jnp.asarray([pos], jnp.int32),
                          jnp.asarray([len(take)], jnp.int32))
        pos += len(take)
        if feed:
            continue
        lg = np.asarray(lg[0].astype(jnp.float32))[:jcfg.vocab_size]
        top = np.sort(lg)[-2:]
        toks.append(int(lg.argmax()))
        margins.append(float(top[1] - top[0]))
        feed = [toks[-1]]
    return toks, margins


@pytest.mark.parametrize("name", ["granite-34b", "chatglm3-6b", "yi-34b",
                                  "llama3-405b"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_greedy_tokens_match_reference_rollout(name, policy):
    """Greedy tokens equal the reference's.  The smoke models' bf16 logits
    often tie (random weights, 256-entry vocab, ulp 2^-6): a race the
    reference wins by less than ``_near_tie`` may be decided either way
    by cross-framework rounding, so the rollouts must agree up to the
    first such near-tie (and may part after it); at least a third of
    all tokens must be compared.  bf16 KV: also ``reference_rollout`` (whole-prompt
    prefill, the same function); int8 KV attends to quantized K/V only
    when the prompt streams through the cache, so its oracle is the
    chunked one alone."""
    pol, kv = POLICIES[policy]
    jcfg, jp, cfg, tp = build(name, pol, kv)
    jcfg = _oracle_cfg(jcfg)
    prompts = _prompts(cfg.vocab_size, seed=sum(map(ord, name + policy)))
    eng, got = _serve(cfg, tp, prompts)
    tie = _near_tie(jcfg)
    compared = 0
    for uid, p in enumerate(prompts):
        ref, margins = chunked_oracle(jp, jcfg, p, NEW)
        compared += _agree_until_near_tie(got[uid], ref, margins, tie)
        if uid == 0 and kv == "bfloat16":
            roll = reference_rollout(jp, jcfg, p, NEW, MAX_LEN)
            _agree_until_near_tie(roll, ref, margins, tie)
            _agree_until_near_tie(got[uid], roll, margins, tie)
    assert 3 * compared >= NEW * len(prompts), compared
    st = eng.stats()
    assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] > 0, st
    assert st["d2h_fetches"] <= st["steps"]      # one fetch per step
    assert st["finished_requests"] == len(prompts)


def test_paged_scan_route_matches_reference_rollout():
    """attn_chunk_kv < max_len: attention runs the paged chunk scan (the
    plain version of the paged-attention kernel) instead of
    full_attention on the gathered view."""
    pol, kv = POLICIES["int4_packed"]
    jcfg, jp, cfg, tp = build("chatglm3-6b", pol, kv, chunk_kv=32)
    prompts = _prompts(cfg.vocab_size, seed=5)[:2]
    _, got = _serve(cfg, tp, prompts)
    for uid, p in enumerate(prompts):
        ref, margins = chunked_oracle(jp, jcfg, p, NEW)
        assert _agree_until_near_tie(got[uid], ref, margins,
                                     _near_tie(jcfg)) >= 1


def test_step_inputs_never_alias_host_state():
    """Every array a step reads is a private copy: mutating the engine's
    numpy state right after the step leaves it unchanged."""
    pol, kv = POLICIES["ternary_dense"]
    _, _, cfg, tp = build("granite-34b", pol, kv)
    eng = ServeEngine(tp, cfg, batch_slots=2, max_len=MAX_LEN, chunk=8,
                      device="cpu")
    seen = []
    inner = eng._step

    def spy(params, batch, caches, *sched):
        seen.append([batch["tokens"], *sched])
        return inner(params, batch, caches, *sched)

    eng._step = spy
    for uid, p in enumerate(_prompts(cfg.vocab_size, seed=1)[:2]):
        eng.submit(Request(uid, p, NEW))
    eng.step()
    before = [t.clone() for t in seen[0]]
    host = [eng.cache_len, eng.block_tables]
    eng.cache_len += 7
    eng.block_tables.fill(3)
    for t, b in zip(seen[0], before):
        assert torch.equal(t, b)
        for a in host:
            lo = a.__array_interface__["data"][0]
            assert not (lo <= t.data_ptr() < lo + a.nbytes)


def test_matches_unbatched_engine():
    """Continuous batching never changes a request's tokens."""
    pol, kv = POLICIES["int4_packed"]
    _, _, cfg, tp = build("granite-34b", pol, kv)
    prompts = _prompts(cfg.vocab_size, seed=3)
    _, batched = _serve(cfg, tp, prompts)
    for uid, p in enumerate(prompts):
        _, alone = _serve(cfg, tp, [p], prefix_reuse=False)
        assert alone[0] == batched[uid]


def test_outside_the_slice_raises():
    """What the port still refuses: media inputs, a non-dense stack and
    the QAT forward (NotImplementedError); a pool below the hard floor
    and an oversize prompt under oversize='error' (ValueError)."""
    from repro_torch.configs.base import BlockSpec
    from repro_torch.nn.linear import ternary_dense_apply
    pol, kv = POLICIES["int4_packed"]
    _, _, cfg, tp = build("granite-34b", pol, kv)
    kw = dict(batch_slots=2, max_len=MAX_LEN, device="cpu")
    eng = ServeEngine(tp, cfg, **kw)
    p = np.arange(5, dtype=np.int32)
    with pytest.raises(NotImplementedError, match="media"):
        eng.submit(Request(0, p, 2, media=np.zeros((4, 8), np.float32)))
    hybrid = cfg.replace(layout=(BlockSpec("mamba", None),
                                 BlockSpec("attn", "mlp")))
    with pytest.raises(NotImplementedError, match="dense"):
        ServeEngine(tp, hybrid, **kw)
    with pytest.raises(NotImplementedError, match="dense"):
        tfm.init(cfg.replace(family="moe"), device="cpu")
    master = {"w": torch.zeros((cfg.d_model, 16))}
    with pytest.raises(NotImplementedError, match="QAT"):
        ternary_dense_apply(master, torch.zeros((1, cfg.d_model)),
                            cfg.ternary)
    # below the hard floor ceil(64 / 16) + 1 = 5 blocks
    with pytest.raises(ValueError):
        ServeEngine(tp, cfg, **kw, num_blocks=4)
    with pytest.raises(ValueError, match="oversize"):
        eng.submit(Request(2, np.zeros(MAX_LEN + 1, np.int32), 2))

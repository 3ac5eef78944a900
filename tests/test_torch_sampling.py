"""Port parity (sampling): ``repro_torch.core.prng`` against
``jax.random``, the sampling tail of ``repro_torch.serve.engine`` against
the reference's own functions, and the sampled engine — siblings, beam
search, guided masks — against a JAX sampled-rollout oracle
(``tests/_torch_sample_ref.py``) and its own invariants.

Tolerances:
  * PRNG keys, random bits and uniforms: bit for bit;
  * Gumbel noise: within 4 ulp of max(|g|, 1) (the logs of two
    libraries; a value near 0 is log(x) at x near 1, where one ulp of x
    is 2^-23 absolute);
  * tokens: equal wherever the reference's two best perturbed scores
    differ by more than 1e-5 (exempt cases are counted: 0 at vocab 256);
  * top-k log-probs within 1e-6 relative; candidate ids equal, on tied
    logits too (ties to the lower id);
  * engine rollouts: equal to the oracle up to the first token whose
    perturbed margin is below the near-tie bound of
    ``test_torch_engine._near_tie`` (ROADMAP P3); the engine's own
    invariants (occupancy, layout and preemption invariance, sibling
    sharing, beam groups) token for token.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (ROADMAP R1)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_sample_ref import sampled_rollout  # noqa: E402
from test_torch_engine import (POLICIES, _near_tie, _oracle_cfg,  # noqa: E402
                               _prompts)
from test_torch_model import build  # noqa: E402

from repro.serve import engine as jeng  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      ternarize_model)

MAX_LEN, BS, CHUNK = 32, 8, 8
F32_TINY = float(np.finfo(np.float32).tiny)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


# -- the PRNG ---------------------------------------------------------------

SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_exact(seed):
    k = jax.random.PRNGKey(seed)
    kt = prng.prng_key(seed)
    np.testing.assert_array_equal(_u32(k), kt.numpy())
    for d in (0, 1, 5, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(_u32(jax.random.fold_in(k, d)),
                                      prng.fold_in(kt, d).numpy())
    # vectorized: one key, a vector of data; then a key per element
    data = np.arange(6) * 977 + 3
    want = np.stack([_u32(jax.random.fold_in(k, int(d))) for d in data])
    got = prng.fold_in(kt, torch.from_numpy(data))
    np.testing.assert_array_equal(want, got.numpy())
    want2 = np.stack([_u32(jax.random.fold_in(jnp.asarray(w, jnp.uint32),
                                              int(d)))
                      for w, d in zip(want, data[::-1])])
    got2 = prng.fold_in(got, torch.from_numpy(data[::-1].copy()))
    np.testing.assert_array_equal(want2, got2.numpy())


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (256,), (2, 3, 4)])
def test_random_bits_and_uniform_bit_exact(shape):
    for seed in (0, 3, 2 ** 32 - 1):
        k, kt = jax.random.PRNGKey(seed), prng.prng_key(seed)
        np.testing.assert_array_equal(_u32(jax.random.bits(k, shape)),
                                      prng.random_bits(kt, shape).numpy())
        for lo, hi in ((0.0, 1.0), (F32_TINY, 1.0), (-0.3, 2.7)):
            want = np.asarray(jax.random.uniform(k, shape, minval=lo,
                                                 maxval=hi))
            got = prng.uniform(kt, shape, minval=lo, maxval=hi).numpy()
            np.testing.assert_array_equal(want.view(np.uint32),
                                          got.view(np.uint32))


def test_per_row_keys_draw_what_each_key_draws():
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(2), i)
                      for i in range(4)])
    want = np.stack([_u32(jax.random.bits(k, (9,))) for k in keys])
    got = prng.random_bits(torch.from_numpy(_u32(keys)), (9,))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_gumbel_within_4_ulp(seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                        (1 << 16,)))
    got = prng.gumbel(prng.prng_key(seed), (1 << 16,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 4 * ulp).all(), \
        float((np.abs(got - want) / ulp).max())


def _margin(scores: np.ndarray) -> np.ndarray:
    top = np.sort(scores, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def test_categorical_one_key_and_per_row_keys():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((6, 256)).astype(np.float32)
    k = jax.random.PRNGKey(4)
    # one key over the whole (6, 256) array
    want = np.asarray(jax.random.categorical(k, lg))
    got = prng.categorical(prng.prng_key(4), torch.from_numpy(lg)).numpy()
    np.testing.assert_array_equal(want, got)
    # a key per row, as the reference's vmap
    keys = jnp.stack([jax.random.fold_in(k, i) for i in range(6)])
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, lg))
    got = prng.categorical(torch.from_numpy(_u32(keys)),
                           torch.from_numpy(lg)).numpy()
    np.testing.assert_array_equal(want, got)


# -- the sampling tail -------------------------------------------------------

def test_sample_token_key_consumption_is_explicit():
    lg = torch.zeros((2, 16))
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="consumes no PRNG key"):
        teng.sample_token(lg, key, temperature=0.0)
    with pytest.raises(ValueError, match="requires a key"):
        teng.sample_token(lg, None, temperature=1.0)
    g = teng.sample_token(lg, None, temperature=0.0)
    s = teng.sample_token(lg, key, temperature=1.0)
    assert g.shape == s.shape == (2,)
    lgn = np.random.default_rng(1).standard_normal((2, 16)).astype(
        np.float32)
    want = np.asarray(jeng.sample_token(jnp.asarray(lgn),
                                        jax.random.PRNGKey(0), 1.0))
    np.testing.assert_array_equal(
        want, teng.sample_token(torch.from_numpy(lgn), key, 1.0).numpy())


def test_derive_sample_key_bit_exact():
    base = jax.random.PRNGKey(3)
    bt = prng.prng_key(3)
    coords = [(5, 1, 9), (0, 0, 0), (2 ** 31 + 7, 3, 2 ** 32 - 1)]
    for c in coords:
        np.testing.assert_array_equal(
            _u32(jeng.derive_sample_key(base, *c)),
            teng.derive_sample_key(bt, *c).numpy())
    cols = [torch.tensor([c[i] for c in coords]) for i in range(3)]
    got = teng.derive_sample_key(bt, *cols).numpy()
    for row, c in zip(got, coords):
        np.testing.assert_array_equal(
            _u32(jeng.derive_sample_key(base, *c)), row)


def _masks(rng, slots, width, vocab):
    m = np.full((slots, width), -1, np.int32)
    for i in range(1, slots):
        n = int(rng.integers(1, width + 1))
        m[i, :n] = rng.integers(0, vocab, n)
    m[2, :3] = [0, 0, 5]            # a duplicate id, and id 0
    return m


def test_apply_token_masks_matches_reference():
    rng = np.random.default_rng(2)
    lg = rng.standard_normal((6, 256)).astype(np.float32)
    m = _masks(rng, 6, 4, 256)
    want = np.asarray(jeng.apply_token_masks(jnp.asarray(lg),
                                             jnp.asarray(m)))
    got = teng.apply_token_masks(torch.from_numpy(lg).to(torch.bfloat16)
                                 .float(), torch.from_numpy(m)).numpy()
    want_b = np.asarray(jeng.apply_token_masks(
        jnp.asarray(lg).astype(jnp.bfloat16), jnp.asarray(m)))
    np.testing.assert_array_equal(want_b, got)
    assert np.array_equal(want[0], lg[0])        # all -1: unconstrained


def _ref_scores(lgm, base, ids, temperature):
    """The reference's perturbed scores of each row's draw."""
    keys = jax.vmap(jeng.derive_sample_key, in_axes=(None, 0, 0, 0))(
        base, ids[:, 0], ids[:, 1], ids[:, 2])
    g = jax.vmap(lambda k: jax.random.gumbel(k, (lgm.shape[-1],)))(keys)
    return np.asarray(g + lgm / temperature)


@pytest.mark.parametrize("temperature", [0.0, 1.0, 0.7])
@pytest.mark.parametrize("topk", [0, 3])
@pytest.mark.parametrize("vocab", [256, 4096])
def test_sample_fn_matches_reference(temperature, topk, vocab):
    rng = np.random.default_rng(int(temperature * 10) + topk + vocab)
    slots = 8
    lg = (rng.standard_normal((slots, vocab)) * 3).astype(np.float32)
    ids = np.stack([rng.integers(0, 2 ** 32, slots),
                    rng.integers(0, 4, slots),
                    rng.integers(0, 100, slots)], 1).astype(np.uint32)
    m = _masks(rng, slots, 4, vocab)
    m[5] = -1
    base, bt = jax.random.PRNGKey(11), prng.prng_key(11)
    want = jeng.make_sample_fn(temperature, topk)(
        jnp.asarray(lg), base, jnp.asarray(ids), jnp.asarray(m))
    got = teng.make_sample_fn(temperature, topk)(
        torch.from_numpy(lg), bt, ids, torch.from_numpy(m))
    if topk:
        (wt, wid, wlp), (gt, gid, glp) = want, got
        np.testing.assert_array_equal(np.asarray(wid), gid.numpy())
        np.testing.assert_allclose(glp.numpy(), np.asarray(wlp),
                                   rtol=1e-6, atol=1e-6)
    else:
        wt, gt = want, got
    wt, gt = np.asarray(wt), gt.numpy()
    lgm = np.asarray(jeng.apply_token_masks(jnp.asarray(lg),
                                            jnp.asarray(m)))
    scores = lgm if temperature <= 0 else \
        _ref_scores(jnp.asarray(lgm), base, jnp.asarray(ids), temperature)
    exempt = _margin(scores) <= 1e-5
    np.testing.assert_array_equal(wt[~exempt], gt[~exempt])
    assert int(exempt.sum()) == 0, int(exempt.sum())


def test_topk_ties_break_to_lower_index():
    lg = np.array([[1, 3, 3, 0, 3], [2, 2, 2, 2, 2]], np.float32)
    m = np.full((2, 2), -1, np.int32)
    ids = np.zeros((2, 3), np.uint32)
    want = jeng.make_sample_fn(1.0, 3)(jnp.asarray(lg),
                                       jax.random.PRNGKey(0),
                                       jnp.asarray(ids), jnp.asarray(m))
    got = teng.make_sample_fn(1.0, 3)(torch.from_numpy(lg),
                                      prng.prng_key(0), ids,
                                      torch.from_numpy(m))
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_array_equal(got[1].numpy(), [[1, 2, 4], [0, 1, 2]])


# -- the sampled engine against the JAX oracle ------------------------------

ORACLE_LEN, ORACLE_NEW = 64, 4


@pytest.mark.parametrize("name", ["granite-34b", "chatglm3-6b"])
@pytest.mark.parametrize("policy", ["ternary_dense", "int4_packed"])
def test_sampled_rollout_matches_jax_oracle(name, policy):
    """Sampled tokens equal the oracle's up to each request's first
    near-tie of perturbed scores; at least a third of all tokens are
    compared.  Padded and packed engines are also token-equal."""
    pol, kv = POLICIES[policy]
    jcfg, jp, cfg, tp = build(name, pol, kv)
    jcfg = _oracle_cfg(jcfg)
    prompts = _prompts(cfg.vocab_size, seed=sum(map(ord, policy + name)))
    outs = []
    for packed in (False, True):
        eng = ServeEngine(tp, cfg, batch_slots=2, max_len=ORACLE_LEN,
                          chunk=8, greedy=False, seed=11, packed=packed,
                          device="cpu")
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid + 20, p, ORACLE_NEW))
        eng.run_until_done()
        outs.append({r.uid: r.out_tokens for r in eng.finished})
    assert outs[0] == outs[1]
    tie = _near_tie(jcfg)
    compared = 0
    for uid, p in enumerate(prompts):
        ref, margins = sampled_rollout(jp, jcfg, p, ORACLE_NEW, ORACLE_LEN,
                                       seed=11, uid=uid + 20)
        for j, (a, b, mg) in enumerate(zip(outs[0][uid + 20], ref,
                                           margins)):
            if mg < tie:
                compared += a == b
                break
            assert a == b, (uid, j, outs[0][uid + 20], ref, margins)
            compared += 1
    assert 3 * compared >= ORACLE_NEW * len(prompts), compared


# -- the engine's own invariants (tests/test_sampling.py, on the port) ------

_STATE = {}


def _params():
    """granite-34b smoke, weight-only serving (the reference's sampling
    tests' setup), made by the port itself."""
    if not _STATE:
        cfg = get_config("granite-34b", smoke=True)
        _STATE["cfg"] = cfg
        _STATE["params"] = ternarize_model(tfm.init(cfg, device="cpu"), cfg,
                                           device="cpu")
    return _STATE["params"], _STATE["cfg"]


def _engine(slots=2, cls=ServeEngine, **kw):
    params, cfg = _params()
    kw.setdefault("greedy", False)
    kw.setdefault("seed", 7)
    return cls(params, cfg, batch_slots=slots, max_len=MAX_LEN, chunk=CHUNK,
               block_size=BS, device="cpu", **kw)


def _drain(eng, max_iters=400):
    it = 0
    while eng.queue or eng._active_slots():
        eng.step()
        eng.validate()
        it += 1
        assert it < max_iters, "engine stopped making progress"
    return {r.uid: r for r in eng.finished}


def _prompt(rng, n):
    return rng.integers(1, _params()[1].vocab_size, n).astype(np.int32)


def test_sampled_rollout_is_slot_occupancy_invariant():
    rng = np.random.default_rng(21)
    target, filler = _prompt(rng, 13), _prompt(rng, 19)
    eng = _engine()
    eng.submit(Request(uid=1, prompt=target, max_new_tokens=6))
    eng.submit(Request(uid=2, prompt=filler, max_new_tokens=6))
    busy = _drain(eng)
    solo_eng = _engine()
    solo_eng.submit(Request(uid=1, prompt=target.copy(), max_new_tokens=6))
    solo = _drain(solo_eng)
    assert busy[1].out_tokens == solo[1].out_tokens
    assert eng.stats()["d2h_fetches"] <= eng.stats()["steps"]


def test_nsample_shares_prompt_blocks_one_prefill():
    rng = np.random.default_rng(8)
    p = _prompt(rng, 2 * BS + 3)
    eng = _engine(slots=4)
    parent = Request(uid=5, prompt=p, max_new_tokens=5, n=4)
    eng.submit(parent)
    done = _drain(eng)
    kids = parent.siblings
    assert len(kids) == 4 and all(k.done for k in kids)
    assert set(done) == {5} and len(eng.finished) == 4
    assert kids[0].prefix_hit_tokens == 0
    for k in kids[1:]:
        assert k.prefix_hit_tokens == len(p) - 1, k.sample_index
    st = eng.stats()
    assert st["sibling_requests"] == 3
    assert st["scheduled_prefill_tokens"] + st["prefix_hit_tokens"] \
        + st["swapped_in_tokens"] == st["admitted_prompt_tokens"]
    assert st["scheduled_prefill_tokens"] == len(p) + 3
    assert st["blocks_in_use"] == 0
    assert len({tuple(k.out_tokens) for k in kids}) > 1


def test_nsample_matches_independent_submissions():
    rng = np.random.default_rng(9)
    p = _prompt(rng, BS + 2)
    eng = _engine()
    parent = Request(uid=3, prompt=p, max_new_tokens=4, n=2)
    eng.submit(parent)
    _drain(eng)
    eng2 = _engine()
    a = Request(uid=3, prompt=p.copy(), max_new_tokens=4)
    b = Request(uid=3, prompt=p.copy(), max_new_tokens=4, sample_index=1)
    eng2.submit(a)
    eng2.submit(b)
    _drain(eng2)
    assert [k.out_tokens for k in parent.siblings] == \
        [a.out_tokens, b.out_tokens]


def test_nsample_packed_parity():
    rng = np.random.default_rng(10)
    p = _prompt(rng, BS + 5)
    outs = []
    for packed in (False, True):
        eng = _engine(slots=4, packed=packed)
        parent = Request(uid=2, prompt=p.copy(), max_new_tokens=5, n=4)
        eng.submit(parent)
        _drain(eng)
        outs.append([k.out_tokens for k in parent.siblings])
    assert outs[0] == outs[1]


class BuggyShare(ServeEngine):
    """Shares the matched tail block in place instead of copying it."""

    def _cow_block(self, slot, jb, src):
        self.pool.incref(src)
        self.block_tables[slot, jb] = src
        self.slot_nblocks[slot] = jb + 1
        return src


def test_sibling_fork_copies_the_tail_block():
    """The sibling's fork is copy-on-write: sharing the tail in place
    lets the sibling's writes corrupt the leader's KV bytes; the real
    engine copies it, and its leader equals a solo run."""
    rng = np.random.default_rng(34)
    p = _prompt(rng, BS + 4)

    def fork_run(cls):
        eng = _engine(cls=cls)
        parent = Request(uid=0, prompt=p.copy(), max_new_tokens=8, n=2)
        eng.submit(parent)
        for _ in range(4):
            eng.step()
        tail = teng.fetch_kv_blocks(eng.caches,
                                    [int(eng.block_tables[0, 1])])
        return eng, parent, tail

    bug_eng, bug_parent, bug_tail = fork_run(BuggyShare)
    good_eng, good_parent, good_tail = fork_run(ServeEngine)
    for par in (bug_parent, good_parent):
        assert par.siblings[1].prefix_hit_tokens == len(p) - 1
    assert bug_eng.block_tables[0, 1] == bug_eng.block_tables[1, 1]
    assert good_eng.block_tables[0, 1] != good_eng.block_tables[1, 1]
    assert any(not torch.equal(bug_tail[k], good_tail[k])
               for k in good_tail)
    solo_eng = _engine()
    solo = Request(uid=0, prompt=p.copy(), max_new_tokens=8)
    solo_eng.submit(solo)
    _drain(solo_eng)
    _drain(good_eng)
    assert good_parent.siblings[0].out_tokens == solo.out_tokens


@pytest.mark.parametrize("preempt", ["swap", "recompute"])
def test_sampled_small_pool_preemption_matches_unpreempted(preempt):
    """Sampled resume is exact: a pool below the full-batch floor
    preempts mid-rollout and every request's tokens equal the default
    pool's (the port's own unpreempted run: the reference's version of
    this test is an R1 victim)."""
    rng = np.random.default_rng(45)
    prompts = [_prompt(rng, n) for n in (20, 22, 21)]

    def run(**kw):
        eng = _engine(**kw)
        reqs = [Request(uid=u, prompt=p.copy(), max_new_tokens=8)
                for u, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        _drain(eng)
        return eng, [r.out_tokens for r in reqs]

    _, base = run()
    for packed in (False, True):
        eng, got = run(num_blocks=6, preempt=preempt, packed=packed)
        assert eng.stats()["preemptions"] > 0
        assert got == base, (packed, got, base)


def test_oversize_truncate_keeps_recent_context():
    rng = np.random.default_rng(30)
    long = _prompt(rng, MAX_LEN + 9)
    eng = _engine(oversize="truncate")
    r = Request(uid=4, prompt=long, max_new_tokens=3)
    eng.submit(r)
    _drain(eng)
    eng2 = _engine()
    r2 = Request(uid=4, prompt=long[-MAX_LEN:].copy(), max_new_tokens=3)
    eng2.submit(r2)
    _drain(eng2)
    assert r.out_tokens == r2.out_tokens and len(long) == MAX_LEN + 9
    with pytest.raises(ValueError, match="oversize='truncate'"):
        _engine().submit(Request(uid=5, prompt=long, max_new_tokens=3))


# -- beam search -------------------------------------------------------------

def test_beam_of_one_equals_greedy():
    rng = np.random.default_rng(12)
    p = _prompt(rng, 10)
    g = Request(uid=1, prompt=p.copy(), max_new_tokens=6)
    greedy_eng = _engine(greedy=True)
    greedy_eng.submit(g)
    _drain(greedy_eng)
    b = Request(uid=1, prompt=p.copy(), max_new_tokens=6,
                sample_mode="beam")
    beam_eng = _engine()
    beam_eng.submit(b)
    _drain(beam_eng)
    assert b.out_tokens == g.out_tokens


@pytest.mark.parametrize("packed", [False, True])
def test_beam_width_two_invariants(packed):
    rng = np.random.default_rng(13)
    p = _prompt(rng, BS + 6)
    eng = _engine(slots=4, packed=packed)
    parent = Request(uid=4, prompt=p, max_new_tokens=6, n=2,
                     sample_mode="beam")
    eng.submit(parent)
    _drain(eng)
    kids = parent.siblings
    assert all(k.done and len(k.out_tokens) == 6 for k in kids)
    assert tuple(kids[0].out_tokens) != tuple(kids[1].out_tokens)
    assert all(np.isfinite(k.cum_logprob) and k.cum_logprob < 0.0
               for k in kids)
    assert eng._beam_groups == {}
    st = eng.stats()
    assert st["beam_forks"] > 0 and st["blocks_in_use"] == 0


def test_beam_submit_validation():
    rng = np.random.default_rng(14)
    p = _prompt(rng, 6)
    eng = _engine(greedy=True)
    with pytest.raises(ValueError, match="greedy=False"):
        eng.submit(Request(uid=1, prompt=p, max_new_tokens=2, n=2,
                           sample_mode="beam"))
    eng2 = _engine()
    with pytest.raises(ValueError, match="batch_slots"):
        eng2.submit(Request(uid=1, prompt=p, max_new_tokens=2, n=3,
                            sample_mode="beam"))
    with pytest.raises(ValueError, match="sample_mode"):
        eng2.submit(Request(uid=1, prompt=p, max_new_tokens=2,
                            sample_mode="nucleus"))
    with pytest.raises(ValueError, match="n must be"):
        eng2.submit(Request(uid=1, prompt=p, max_new_tokens=2, n=0))


# -- guided decoding ---------------------------------------------------------

def test_allowed_tokens_constrains_every_position_padded_and_packed():
    rng = np.random.default_rng(15)
    p = _prompt(rng, 9)
    allowed = [3, 7, 11]
    outs = []
    for packed in (False, True):
        eng = _engine(packed=packed)
        req = Request(uid=6, prompt=p.copy(), max_new_tokens=6,
                      allowed_tokens=lambda out: allowed)
        eng.submit(req)
        _drain(eng)
        assert all(t in allowed for t in req.out_tokens), req.out_tokens
        assert eng.stats()["masked_tokens"] == 6
        outs.append(req.out_tokens)
    assert outs[0] == outs[1]


def test_allowed_tokens_none_means_unconstrained():
    rng = np.random.default_rng(16)
    p = _prompt(rng, 9)
    eng = _engine()
    req = Request(uid=6, prompt=p, max_new_tokens=5,
                  allowed_tokens=lambda out: None)
    eng.submit(req)
    _drain(eng)
    bare_eng = _engine()
    bare = Request(uid=6, prompt=p.copy(), max_new_tokens=5)
    bare_eng.submit(bare)
    _drain(bare_eng)
    assert req.out_tokens == bare.out_tokens
    assert eng.stats()["masked_tokens"] == 0


def test_allowed_tokens_greedy_engine():
    rng = np.random.default_rng(17)
    p = _prompt(rng, 9)
    allowed = [2, 5]
    eng = _engine(greedy=True)
    req = Request(uid=6, prompt=p, max_new_tokens=4,
                  allowed_tokens=lambda out: allowed)
    eng.submit(req)
    _drain(eng)
    assert all(t in allowed for t in req.out_tokens), req.out_tokens


def test_mask_width_overflow_and_empty_raise():
    rng = np.random.default_rng(18)
    p = _prompt(rng, 9)
    eng = _engine(mask_width=2)
    eng.submit(Request(uid=1, prompt=p, max_new_tokens=2,
                       allowed_tokens=lambda out: [1, 2, 3]))
    with pytest.raises(ValueError, match="mask_width"):
        _drain(eng)
    eng2 = _engine()
    eng2.submit(Request(uid=1, prompt=p.copy(), max_new_tokens=2,
                        allowed_tokens=lambda out: []))
    with pytest.raises(ValueError, match="empty"):
        _drain(eng2)

"""Port parity (self-speculative decoding): the accept function against
the reference's ``make_spec_accept_fn``, the draft and verify steps
against the reference's and against the port's own unified step, and
the speculative engine's contracts (tests/test_spec_decode.py) on the
port's own runs.

Tolerances:
  * accept function: emitted tokens and accepted counts equal, up to the
    first position of a row where the reference's decision is a
    near-tie (|u - p(d)| or a Gumbel draw's top-two margin <= 1e-5;
    greedy: the argmax's top-two margin); exempt rows are counted;
  * verify step: each position's logits bit-equal to the port's unified
    step decoding that position alone (the lossless contract), and
    within the model tolerance of the reference's verify step
    (test_torch_model.py: 0.0625, weight-only serving); draft tokens
    equal to the argmax of the unified step under the draft policy;
  * engine: greedy speculation token-equal to greedy decoding, padded
    and packed; sampled speculation without drafts bit-equal to plain
    sampling; every step followed by ``validate()``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (ROADMAP R1)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_model import build  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      ternarize_model)

MAX_LEN, BS, CHUNK = 32, 8, 8
# policy A of the card runs: int4 bit-serial target on packed codes,
# whose int2 draft is the bit-serial kernel at bits = 2
INT4 = dict(encoding="symmetric", act_mode="int4", pack=True)


# -- the accept function -----------------------------------------------------

def _accept_inputs(rng, slots, chunk, vocab):
    lg = (rng.standard_normal((slots, chunk, vocab)) * 2).astype(np.float32)
    toks = rng.integers(0, vocab, (slots, chunk)).astype(np.int32)
    start = np.zeros((slots,), np.int32)
    n_draft = np.zeros((slots,), np.int32)
    # decode rows: start 0, k drafts; a prefill row: start n_new - 1
    n_draft[:3] = [3, chunk - 1, 0]
    start[3] = 5
    # drafts the argmax accepts for a while: row 0 copies its argmax
    # chain for two positions, row 1 for all of it
    for i, upto in ((0, 2), (1, chunk - 1)):
        for j in range(upto):
            toks[i, j + 1] = int(lg[i, j].argmax())
    ids = np.stack([rng.integers(0, 2 ** 32, slots),
                    rng.integers(0, 3, slots),
                    rng.integers(0, 50, slots)], 1).astype(np.uint32)
    masks = np.full((slots, chunk, 4), -1, np.int32)
    masks[2, :, :3] = rng.integers(0, vocab, (chunk, 3))
    return lg, toks, start, n_draft, ids, masks


def _ref_margins(lg, toks, start, n_draft, ids, masks, temperature, base):
    """(slots, chunk) margin of the reference's decision at each
    position: the smallest of |u - p(d)| and the Gumbel draws' top-two
    margins (greedy: the argmax's)."""
    slots, chunk, vocab = lg.shape
    out = np.full((slots, chunk), np.inf)

    def top2(x):
        t = np.sort(np.asarray(x))[-2:]
        return float(t[1] - t[0])

    for i in range(slots):
        for j in range(chunk):
            row = jeng.apply_token_masks(
                jnp.asarray(lg[i, min(start[i] + j, chunk - 1)])[None],
                jnp.asarray(masks[i, j])[None])[0]
            if temperature <= 0:
                out[i, j] = top2(row)
                continue
            d = int(toks[i, min(start[i] + j + 1, chunk - 1)])
            key = jeng.derive_sample_key(base, int(ids[i, 0]),
                                         int(ids[i, 1]),
                                         int(ids[i, 2]) + j)
            scaled = row / temperature
            u = jax.random.uniform(jax.random.fold_in(key, 1))
            p = jax.nn.softmax(scaled)[d]
            banned = jnp.where(jnp.arange(vocab) == d, -jnp.inf, row)
            g_res = jax.random.gumbel(jax.random.fold_in(key, 2), (vocab,))
            g_bon = jax.random.gumbel(key, (vocab,))
            out[i, j] = min(abs(float(u) - float(p)),
                            top2(g_res + banned / temperature),
                            top2(g_bon + scaled))
    return out


@pytest.mark.parametrize("temperature", [0.0, 1.0, 0.7])
def test_accept_fn_matches_reference(temperature):
    rng = np.random.default_rng(int(temperature * 10) + 3)
    slots, chunk, vocab = 5, 8, 256
    lg, toks, start, n_draft, ids, masks = _accept_inputs(rng, slots, chunk,
                                                          vocab)
    base = jax.random.PRNGKey(5)
    w_emit, w_n = jeng.make_spec_accept_fn(temperature, chunk)(
        jnp.asarray(lg), jnp.asarray(toks), jnp.asarray(start),
        jnp.asarray(n_draft), base, jnp.asarray(ids), jnp.asarray(masks))
    g_emit, g_n = teng.make_spec_accept_fn(temperature)(
        torch.from_numpy(lg), torch.from_numpy(toks),
        torch.from_numpy(start), torch.from_numpy(n_draft),
        prng.prng_key(5), ids, torch.from_numpy(masks))
    w_emit, w_n = np.asarray(w_emit), np.asarray(w_n)
    g_emit, g_n = g_emit.numpy(), g_n.numpy()
    margins = _ref_margins(lg, toks, start, n_draft, ids, masks,
                           temperature, base)
    exempt = 0
    for i in range(slots):
        for j in range(int(w_n[i])):
            if margins[i, j] <= 1e-5:
                exempt += 1
                break
            assert g_emit[i, j] == w_emit[i, j], (i, j)
        else:
            assert g_n[i] == w_n[i], (i, g_n, w_n)
    assert exempt == 0, exempt
    if temperature <= 0:
        # the constructed drafts: row 0 accepts exactly 2, row 1 all
        assert list(g_n[:2]) == [3, chunk]


# -- the draft and verify steps ----------------------------------------------

def _paged_inputs(slots, nblk, toks_per_slot, cache_len):
    """Block tables (slot i owns blocks i*nblk ...), and the slot map of
    ``toks_per_slot`` new tokens at ``cache_len``."""
    tables = np.arange(slots * nblk, dtype=np.int32).reshape(slots, nblk)
    smap = np.full((slots, CHUNK), slots * nblk * BS, np.int32)
    for i in range(slots):
        pos = cache_len[i] + np.arange(toks_per_slot[i])
        smap[i, :len(pos)] = tables[i, pos // BS] * BS + pos % BS
    return tables, smap


def _caches_copy(caches):
    return [{k: v.clone() for k, v in layer.items()} for layer in caches]


@pytest.mark.parametrize("policy", ["weight_only", "int4"])
def test_verify_columns_equal_one_token_decodes(policy):
    """Column j of the verify step (padded and packed) is the same bits
    as the unified step decoding that position alone, and the draft step
    proposes the draft policy's masked argmax."""
    cfg = get_config("granite-34b", smoke=True)
    if policy == "int4":
        cfg = cfg.replace(ternary=cfg.ternary.replace(**INT4))
    params = ternarize_model(tfm.init(cfg, seed=3, device="cpu"), cfg,
                             device="cpu")
    slots, nblk = 2, MAX_LEN // BS
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (slots, CHUNK)).astype(np.int32)
    caches = tfm.init_paged_caches(cfg, slots, slots * nblk + 1, BS, "cpu")
    step = teng.make_paged_unified_step(cfg)
    cl = np.zeros((slots,), np.int32)
    nn_ = np.full((slots,), CHUNK, np.int32)
    tables, smap = _paged_inputs(slots, nblk, nn_, cl)
    t = torch.from_numpy
    _, caches = step(params, {"tokens": t(prompt)}, caches, t(cl), t(nn_),
                     t(tables), t(smap))
    cl = cl + CHUNK
    k = 3
    new = rng.integers(0, cfg.vocab_size, (slots, k + 1)).astype(np.int32)
    # one token at a time
    solo, c1 = [], _caches_copy(caches)
    for j in range(k + 1):
        grid = np.zeros((slots, CHUNK), np.int32)
        grid[:, 0] = new[:, j]
        one = np.ones((slots,), np.int32)
        _, sm = _paged_inputs(slots, nblk, one, cl + j)
        lg, c1 = step(params, {"tokens": t(grid)}, c1, t(cl + j), t(one),
                      t(tables), t(sm))
        solo.append(lg)
    # all k + 1 in one padded verify step
    grid = np.zeros((slots, CHUNK), np.int32)
    grid[:, :k + 1] = new
    nk = np.full((slots,), k + 1, np.int32)
    _, sm = _paged_inputs(slots, nblk, nk, cl)
    every = torch.arange(CHUNK).expand(slots, CHUNK)
    lgv, _ = teng.make_paged_spec_step(cfg)(
        params, {"tokens": t(grid)}, _caches_copy(caches), t(cl), t(nk),
        t(tables), t(sm), every)
    for j in range(k + 1):
        assert torch.equal(lgv[:, j], solo[j]), j
    # only the columns acceptance reads (a slot's own start each)
    cols = torch.tensor([[0, 1], [2, 3]])
    lgc, _ = teng.make_paged_spec_step(cfg)(
        params, {"tokens": t(grid)}, _caches_copy(caches), t(cl), t(nk),
        t(tables), t(sm), cols)
    assert torch.equal(lgc, lgv.gather(1, cols[..., None].expand(
        -1, -1, lgv.shape[-1])))
    # the same tokens through the packed verify step
    eng = ServeEngine(params, cfg, batch_slots=slots, max_len=MAX_LEN,
                      chunk=CHUNK, block_size=BS, packed=True, spec_k=k,
                      device="cpu")
    eng.cache_len[:] = cl
    flat, seg, pos, pnn, psm, row_idx, _ = eng._flatten_spec_grid(
        grid, nk, sm)
    lgp, _ = teng.make_packed_spec_step(cfg)(
        params, {"tokens": t(flat)}, _caches_copy(caches), t(pos), t(pnn),
        t(seg), t(tables), t(psm), t(row_idx), every)
    if policy == "int4":
        # TiM products are exact whatever the bucket; weight-only bf16
        # matmuls of another M may round otherwise
        for j in range(k + 1):
            assert torch.equal(lgp[:, j], solo[j]), j
    # the draft step: the draft policy's argmax under a mask
    dcfg = cfg.replace(ternary=cfg.ternary.draft("int2"))
    mask = np.full((slots, 4), -1, np.int32)
    mask[1, :2] = [7, 9]
    one = np.ones((slots,), np.int32)
    _, sm = _paged_inputs(slots, nblk, one, cl)
    dt, _ = teng.make_draft_step(dcfg)(
        params, {"tokens": t(new[:, :1])}, _caches_copy(caches), t(cl),
        t(one), t(tables), t(sm[:, :1].copy()), t(mask))
    grid = np.zeros((slots, CHUNK), np.int32)
    grid[:, 0] = new[:, 0]
    lgd, _ = teng.make_paged_unified_step(dcfg)(
        params, {"tokens": t(grid)}, _caches_copy(caches), t(cl), t(one),
        t(tables), t(sm))
    want = teng.apply_token_masks(lgd, t(mask)).argmax(-1)
    assert torch.equal(dt.long(), want)
    assert int(dt[1]) in (7, 9)


def test_verify_step_matches_reference():
    """The paged verify step against the reference's
    ``make_paged_spec_step`` on the same params and inputs (weight-only
    serving, full smoke depth), and the draft step's proposals against
    the reference's draft step where its argmax is no near-tie."""
    jcfg, jp, cfg, tp = build("chatglm3-6b", {})
    slots, nblk = 2, MAX_LEN // BS
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (slots, CHUNK)).astype(np.int32)
    cl = np.zeros((slots,), np.int32)
    nn_ = np.array([CHUNK, 5], np.int32)
    tables, smap = _paged_inputs(slots, nblk, nn_, cl)
    nb = slots * nblk + 1
    jc = jtfm.init_paged_caches(jcfg, slots, nb, BS)
    tc = tfm.init_paged_caches(cfg, slots, nb, BS, "cpu")
    t = torch.from_numpy
    jlg, jc = jeng.make_paged_spec_step(jcfg)(
        jp, {"tokens": jnp.asarray(prompt)}, jc, jnp.asarray(cl),
        jnp.asarray(nn_), jnp.asarray(tables), jnp.asarray(smap))
    tlg, tc = teng.make_paged_spec_step(cfg)(
        tp, {"tokens": t(prompt)}, tc, t(cl), t(nn_), t(tables), t(smap),
        torch.arange(CHUNK).expand(slots, CHUNK))
    jl = np.asarray(jlg.astype(jnp.float32))
    tl = tlg.float().numpy()
    for i in range(slots):
        np.testing.assert_allclose(tl[i, :nn_[i], :cfg.vocab_size],
                                   jl[i, :nn_[i], :cfg.vocab_size],
                                   atol=0.0625, rtol=0)
    # a draft pass on the prefilled caches (int2 draft of the codes)
    cl = nn_.copy()
    one = np.ones((slots,), np.int32)
    tables, smap = _paged_inputs(slots, nblk, one, cl)
    d_tok = prompt[:, -1:].copy()
    mask = np.full((slots, 4), -1, np.int32)
    jd = jeng.make_draft_step(jcfg.replace(
        ternary=jcfg.ternary.draft("int2")))
    td = teng.make_draft_step(cfg.replace(ternary=cfg.ternary.draft("int2")))
    grid = np.zeros((slots, CHUNK), np.int32)
    grid[:, :1] = d_tok
    _, smap_g = _paged_inputs(slots, nblk, one, cl)
    jlg_d, _ = jeng.make_paged_unified_step(jcfg.replace(
        ternary=jcfg.ternary.draft("int2")))(
        jp, {"tokens": jnp.asarray(grid)}, jc, jnp.asarray(cl),
        jnp.asarray(one), jnp.asarray(tables), jnp.asarray(smap_g))
    jt, _ = jd(jp, {"tokens": jnp.asarray(d_tok)}, jc, jnp.asarray(cl),
               jnp.asarray(one), jnp.asarray(tables),
               jnp.asarray(smap[:, :1]), jnp.asarray(mask))
    tt, _ = td(tp, {"tokens": t(d_tok)}, tc, t(cl), t(one), t(tables),
               t(smap[:, :1].copy()), t(mask))
    top = np.sort(np.asarray(jlg_d.astype(jnp.float32))[:, :cfg.vocab_size],
                  axis=-1)[:, -2:]
    clear = (top[:, 1] - top[:, 0]) > 2.0 ** -3     # int activations: P3
    np.testing.assert_array_equal(np.asarray(jt)[clear], tt.numpy()[clear])
    print("draft proposals compared:", int(clear.sum()), "of", slots)


# -- the speculative engine (tests/test_spec_decode.py, on the port) -------

_STATE = {}


def _params(policy="weight_only"):
    """granite-34b smoke made by the port: weight-only serving (the
    reference's spec tests' setup: the int2 draft disagrees with the
    target often, so rollback runs a lot), or policy A (int4 target)."""
    if policy not in _STATE:
        cfg = get_config("granite-34b", smoke=True)
        if policy == "int4":
            cfg = cfg.replace(ternary=cfg.ternary.replace(**INT4))
        _STATE[policy] = (ternarize_model(tfm.init(cfg, device="cpu"), cfg,
                                          device="cpu"), cfg)
    return _STATE[policy]


def _engine(slots=2, policy="weight_only", **kw):
    params, cfg = _params(policy)
    kw.setdefault("greedy", True)
    kw.setdefault("seed", 7)
    return ServeEngine(params, cfg, batch_slots=slots, max_len=MAX_LEN,
                       chunk=CHUNK, block_size=BS, device="cpu", **kw)


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


def _run(reqs_fn, **kw):
    eng = _engine(**kw)
    reqs = reqs_fn()
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    return eng, reqs


@pytest.mark.parametrize("policy", ["weight_only", "int4"])
def test_lossless_greedy_padded_and_packed(policy):
    """Greedy speculation emits what greedy decoding does, padded and
    packed, in no more steps."""
    rng = np.random.default_rng(40)
    prompts = [_prompt(rng, 5), _prompt(rng, 9), _prompt(rng, 14)]

    def reqs():
        return [Request(uid=u, prompt=p.copy(), max_new_tokens=10)
                for u, p in enumerate(prompts)]

    base_eng, base = _run(reqs, policy=policy)
    for packed in (False, True):
        eng, got = _run(reqs, policy=policy, spec_k=3, packed=packed)
        assert [r.out_tokens for r in got] == \
            [r.out_tokens for r in base], packed
        st = eng.stats()
        assert st["draft_tokens"] == \
            st["accepted_tokens"] + st["rejected_tokens"] > 0
        assert st["steps"] <= base_eng.stats()["steps"]
        assert st["blocks_in_use"] == 0


def test_spec_counters_and_emission_identity():
    rng = np.random.default_rng(41)
    reqs = lambda: [Request(uid=u, prompt=_prompt(rng, 6),  # noqa: E731
                            max_new_tokens=8) for u in range(3)]
    eng, got = _run(reqs, spec_k=2)
    st = eng.stats()
    decode_sched = st["scheduled_tokens"] - st["scheduled_prefill_tokens"]
    assert st["output_tokens"] + st["rejected_tokens"] \
        == decode_sched + len(got)
    assert st["output_tokens"] == sum(len(r.out_tokens) for r in got)
    assert st["draft_d2h_fetches"] > 0
    assert st["d2h_fetches"] <= st["steps"]
    assert st["bonus_tokens"] <= st["accepted_tokens"]


def test_sampled_k0_bit_identical_to_nonspec():
    """token_budget=1 leaves no budget for drafts: the spec engine's
    verify and accept path replays plain sampling bit for bit."""
    rng = np.random.default_rng(42)
    prompts = [_prompt(rng, 7), _prompt(rng, 11)]

    def reqs():
        return [Request(uid=u, prompt=p.copy(), max_new_tokens=6)
                for u, p in enumerate(prompts)]

    for packed in (False, True):
        _, base = _run(reqs, greedy=False, token_budget=1, packed=packed)
        eng, got = _run(reqs, greedy=False, token_budget=1, spec_k=2,
                        packed=packed)
        assert eng.stats()["draft_tokens"] == 0
        assert [r.out_tokens for r in got] == [r.out_tokens for r in base]


def test_sampled_spec_replay_is_deterministic():
    rng = np.random.default_rng(43)
    prompts = [_prompt(rng, 6), _prompt(rng, 10)]

    def reqs():
        return [Request(uid=u, prompt=p.copy(), max_new_tokens=8)
                for u, p in enumerate(prompts)]

    runs = []
    for packed in (False, True, False):
        eng, got = _run(reqs, greedy=False, spec_k=2, packed=packed)
        st = eng.stats()
        assert st["draft_tokens"] > 0
        runs.append(([r.out_tokens for r in got], st["draft_tokens"],
                      st["accepted_tokens"], st["rejected_tokens"],
                      st["bonus_tokens"]))
    assert runs[0] == runs[1] == runs[2]


def test_rejection_rollback_preserves_committed_kv_bytes():
    """A spec engine (heavy rejection) and a non-spec engine driven to
    the same emitted length hold the same bytes at every committed KV
    position."""
    rng = np.random.default_rng(44)
    p = _prompt(rng, 6)
    want_out = 8

    def drive(spec_k):
        eng = _engine(slots=1, spec_k=spec_k)
        req = Request(uid=0, prompt=p.copy(), max_new_tokens=20)
        eng.submit(req)
        it = 0
        while len(req.out_tokens) < want_out:
            eng.step()
            eng.validate()
            it += 1
            assert it < 100
        assert not req.done
        return eng, req

    spec_eng, spec_req = drive(3)
    base_eng, base_req = drive(0)
    assert spec_eng.stats()["rejected_tokens"] > 0
    n = min(len(spec_req.out_tokens), len(base_req.out_tokens))
    assert spec_req.out_tokens[:n] == base_req.out_tokens[:n]
    cl = len(p) + n - 1
    nb = -(-cl // BS)
    a = teng.fetch_kv_blocks(spec_eng.caches,
                             [int(b) for b in spec_eng.block_tables[0, :nb]])
    b = teng.fetch_kv_blocks(base_eng.caches,
                             [int(x) for x in base_eng.block_tables[0, :nb]])
    assert set(a) == set(b) and a
    for key in a:
        for g in range(cl):
            assert torch.equal(a[key][:, g // BS, g % BS],
                               b[key][:, g // BS, g % BS]), (key, g)


def test_spec_small_pool_preemption_parity():
    rng = np.random.default_rng(45)
    prompts = [_prompt(rng, 20), _prompt(rng, 22), _prompt(rng, 21)]

    def reqs():
        return [Request(uid=u, prompt=p.copy(), max_new_tokens=8)
                for u, p in enumerate(prompts)]

    _, base = _run(reqs)
    for preempt in ("swap", "recompute"):
        eng, got = _run(reqs, num_blocks=6, preempt=preempt, spec_k=2)
        st = eng.stats()
        assert st["preemptions"] > 0 and st["draft_tokens"] > 0
        assert [r.out_tokens for r in got] == [r.out_tokens for r in base]
        assert st["blocks_in_use"] == 0
        assert st["scheduled_prefill_tokens"] + st["prefix_hit_tokens"] \
            + st["swapped_in_tokens"] == st["admitted_prompt_tokens"]


def test_spec_nsample_siblings():
    rng = np.random.default_rng(46)
    p = _prompt(rng, BS + 3)

    def run(**kw):
        eng = _engine(slots=4, greedy=False, **kw)
        parent = Request(uid=9, prompt=p.copy(), max_new_tokens=6, n=4)
        eng.submit(parent)
        _drain(eng)
        return eng, parent

    eng, parent = run(spec_k=2)
    kids = parent.siblings
    assert len(kids) == 4 and all(k.done for k in kids)
    assert len({tuple(k.out_tokens) for k in kids}) > 1
    st = eng.stats()
    assert st["sibling_requests"] == 3 and st["draft_tokens"] > 0
    assert st["blocks_in_use"] == 0
    assert [k.out_tokens for k in run(spec_k=2)[1].siblings] == \
        [k.out_tokens for k in kids]
    eng3, p3 = run(spec_k=2, token_budget=1)
    assert eng3.stats()["draft_tokens"] == 0
    assert [k.out_tokens for k in p3.siblings] == \
        [k.out_tokens for k in run()[1].siblings]


def test_guided_masks_constrain_draft_and_verify_packed_parity():
    rng = np.random.default_rng(47)
    p = _prompt(rng, 9)
    allowed = [3, 7, 11]

    def run(spec_k, packed):
        eng = _engine(spec_k=spec_k, packed=packed)
        req = Request(uid=6, prompt=p.copy(), max_new_tokens=6,
                      allowed_tokens=lambda out: allowed)
        eng.submit(req)
        _drain(eng)
        assert all(t in allowed for t in req.out_tokens), req.out_tokens
        assert eng.stats()["masked_tokens"] == 6
        return eng, req.out_tokens

    _, base = run(0, False)
    for packed in (False, True):
        eng, got = run(2, packed)
        assert got == base, packed
        assert eng.stats()["draft_tokens"] > 0


def test_spec_submit_and_init_validation():
    rng = np.random.default_rng(50)
    eng = _engine(greedy=False, spec_k=2)
    with pytest.raises(ValueError, match="does not compose"):
        eng.submit(Request(uid=1, prompt=_prompt(rng, 6), max_new_tokens=2,
                           n=2, sample_mode="beam"))
    params, cfg = _params("int4")
    with pytest.raises(ValueError, match="wider"):
        ServeEngine(params, cfg, batch_slots=2, max_len=MAX_LEN,
                    chunk=CHUNK, block_size=BS, spec_k=2,
                    draft_act_mode="int5", device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        _engine(spec_k=-1)
    # the draft config reads the target's codes through int2
    eng = _engine(policy="int4", spec_k=2)
    assert eng._draft_cfg.ternary.act_mode == "int2"
    assert eng._draft_cfg.ternary.pack and eng.cfg.ternary.act_bits == 4

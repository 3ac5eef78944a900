"""Port parity (token-packed layout): ``packed_mixed_attention``, the
packed-query paged attention's plain version, ``forward(seg_ids=)``,
``_flatten_grid`` and the ``packed=True`` engine, against the JAX
reference and against the port's own padded grid.

Tolerances:
  * port vs reference attention (XLA oracle and the Pallas packed-query
    kernel in interpret mode): f32 scores and softmax in another
    reduction order, one rounding to bf16, so |diff| <= 2^-7 * |ref| +
    2e-3 (about one bf16 ulp);
  * port packed vs port padded, attention and model: bit for bit — a
    packed token is its own batch row at S = 1 through the same chunk
    scan, masks and chunk boundaries (the reference's own contract,
    tests/test_attention.py);
  * model forward vs reference, weight-only serving: |diff| <= 0.0625
    (as tests/test_torch_model.py);
  * engine: packed tokens equal padded tokens exactly; both equal the
    reference's oracle rollout up to its first near-tie (as
    tests/test_torch_engine.py holds the padded engine).
Padding tokens (seg -1, kv_valid_len 0) come out exactly 0 on the paged
scan (the kernel's route and its plain version); caches that fit one
chunk take full attention, where a fully masked row is the mean of V,
as in the reference — the caller discards those rows either way.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (the reference engine's tests are timing-
# sensitive under this jax version, ROADMAP R1)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from _serve_ref import reference_rollout  # noqa: E402
from test_torch_engine import (POLICIES, _agree_until_near_tie,  # noqa: E402
                               _near_tie, _oracle_cfg, _prompts, _serve,
                               chunked_oracle)
from test_torch_model import build  # noqa: E402

from repro.kernels.paged_attention import paged_packed_attention_pallas  # noqa: E402,E501
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.transformer import _kv_quantize as j_kv_quantize  # noqa: E402,E501
from repro.nn.attention import packed_mixed_attention as j_packed  # noqa: E402,E501
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.transformer import _kv_quantize  # noqa: E402
from repro_torch.nn.attention import (mixed_attention,  # noqa: E402
                                      packed_mixed_attention)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

H, HK, D, BS, NBLK, NB = 4, 2, 16, 16, 6, 30
# per-slot offsets / new tokens of one mixed step: a prefill chunk past
# a block boundary, a fresh prompt, a decode at a long cache, an idle
# slot
OFFS, N_NEW = [37, 0, 70, 0], [4, 5, 1, 0]
CHUNK = max(N_NEW)
BUCKET = 16                       # next power of two above 10 tokens


def _layout(pad_to=BUCKET):
    """The engine's flat layout: per-token seg / kv_valid_len / q_offset
    and each token's (slot, column), padded with seg -1 tokens."""
    seg, vlen, qoff, where = [], [], [], []
    for i, (o, n) in enumerate(zip(OFFS, N_NEW)):
        for j in range(n):
            seg.append(i)
            vlen.append(o + j + 1)
            qoff.append(o + j)
            where.append((i, j))
    while len(seg) < pad_to:
        seg.append(-1)
        vlen.append(0)
        qoff.append(0)
        where.append(None)
    return (np.asarray(seg, np.int32), np.asarray(vlen, np.int32),
            np.asarray(qoff, np.int32), where)


def _inputs(seed, quant):
    """(reference tuple, reference scale kwargs, port tuple, port scale
    kwargs); padded q (slots, CHUNK, H, D) and its flat (T, 1, H, D)
    view, the pool, and the per-slot table (unassigned entries -1)."""
    rng = np.random.default_rng(seed)
    slots = len(OFFS)
    qpad = rng.standard_normal((slots, CHUNK, H, D)).astype(np.float32)
    k = rng.standard_normal((NB, BS, HK, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, HK, D)).astype(np.float32)
    tbl = rng.permutation(NB)[:slots * NBLK].reshape(slots, NBLK)
    tbl = tbl.astype(np.int32)
    tbl[1, 1:] = -1
    seg, vlen, qoff, where = _layout()
    qflat = np.stack([qpad[w] if w is not None else np.zeros((H, D),
                                                            np.float32)
                      for w in where])[:, None]
    jq, jqf = (jnp.asarray(a).astype(jnp.bfloat16) for a in (qpad, qflat))
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    tq, tqf, tk, tv = (torch.from_numpy(a).bfloat16()
                       for a in (qpad, qflat, k, v))
    jkw, tkw = {}, {}
    if quant:
        jk, jks = j_kv_quantize(jk)
        jv, jvs = j_kv_quantize(jv)
        tk, tks = _kv_quantize(tk)
        tv, tvs = _kv_quantize(tv)
        jkw = dict(k_scale=jks, v_scale=jvs)
        tkw = dict(k_scale=tks, v_scale=tvs)
    flat = (seg, vlen, qoff)
    j = (jq, jqf, jk, jv, jnp.asarray(tbl)) + tuple(map(jnp.asarray, flat))
    t = (tq, tqf, tk, tv, torch.from_numpy(tbl)) + tuple(
        map(torch.from_numpy, flat))
    return j, jkw, t, tkw, where


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _close(ours, ref, where, scan=True):
    o, r = _np(ours), _np(ref)
    assert np.isfinite(o).all()
    assert (np.abs(o - r) <= np.abs(r) * 2.0 ** -7 + 2e-3).all(), \
        np.abs(o - r).max()
    pad = [t for t, w in enumerate(where) if w is None]
    assert not scan or not o[pad].any()   # padding tokens are exactly 0


# chunk 32: the paged chunk scan (the kernel's plain version); 96: the
# whole table fits one chunk, full attention on the gathered view
@pytest.mark.parametrize("chunk", [32, NBLK * BS])
@pytest.mark.parametrize("quant", [False, True])
def test_packed_attention_matches_reference_xla(quant, chunk):
    j, jkw, t, tkw, where = _inputs(1, quant)
    _, jqf, jk, jv, jt, jseg, jvl, jqo = j
    _, tqf, tk, tv, tt, tseg, tvl, tqo = t
    ours = packed_mixed_attention(tqf, tk, tv, tseg, tvl, tqo,
                                  chunk_kv=chunk, block_tables=tt, **tkw)
    ref = j_packed(jqf, jk, jv, jseg, jvl, jqo, chunk_kv=chunk,
                   block_tables=jt, impl="xla", **jkw)
    _close(ours, ref, where, scan=chunk < NBLK * BS)


@pytest.mark.parametrize("quant", [False, True])
def test_packed_plain_matches_reference_pallas(quant):
    """The kernel's plain version against the reference's packed-query
    Pallas kernel, run in interpret mode."""
    j, jkw, t, tkw, where = _inputs(2, quant)
    _, jqf, jk, jv, jt, jseg, jvl, jqo = j
    _, tqf, tk, tv, tt, tseg, tvl, tqo = t
    reset_launch_counts()
    ours = pk.paged_packed_attention(tqf, tk, tv, tt, tseg, tvl,
                                     q_offset=tqo, chunk_kv=32, **tkw)
    assert not any(launch_counts().values())     # CPU: plain version
    ref = paged_packed_attention_pallas(jqf, jk, jv, jt, jseg, jvl,
                                        q_offset=jqo, chunk_kv=32,
                                        interpret=True, **jkw)
    _close(ours, ref, where)
    _close(pk.paged_packed_attention_plain(
        tqf, tk, tv, tt, tseg, tvl, q_offset=tqo, chunk_kv=32, **tkw),
        ref, where)


@pytest.mark.parametrize("chunk", [32, NBLK * BS])
@pytest.mark.parametrize("quant", [False, True])
def test_packed_attention_equals_padded_per_token(quant, chunk):
    _, _, t, tkw, where = _inputs(3, quant)
    tq, tqf, tk, tv, tt, tseg, tvl, tqo = t
    offs = torch.tensor(OFFS, dtype=torch.int32)
    vlen_slot = offs + torch.tensor(N_NEW, dtype=torch.int32)
    padded = mixed_attention(tq, tk, tv, vlen_slot, offs, chunk_kv=chunk,
                             block_tables=tt, **tkw)
    packed = packed_mixed_attention(tqf, tk, tv, tseg, tvl, tqo,
                                    chunk_kv=chunk, block_tables=tt, **tkw)
    for tok, w in enumerate(where):
        if w is None:
            assert chunk == NBLK * BS or not packed[tok].any()
            continue
        assert torch.equal(packed[tok, 0], padded[w]), (tok, w)


def test_packed_contiguous_cache_equals_padded():
    """Contiguous (slots, S_max) caches: each token reads its segment's
    row."""
    _, _, t, _, where = _inputs(4, False)
    tq, tqf, _, _, _, tseg, tvl, tqo = t
    rng = np.random.default_rng(4)
    kc = torch.from_numpy(rng.standard_normal(
        (len(OFFS), NBLK * BS, HK, D)).astype(np.float32)).bfloat16()
    vc = torch.from_numpy(rng.standard_normal(
        (len(OFFS), NBLK * BS, HK, D)).astype(np.float32)).bfloat16()
    offs = torch.tensor(OFFS, dtype=torch.int32)
    vlen_slot = offs + torch.tensor(N_NEW, dtype=torch.int32)
    padded = mixed_attention(tq, kc, vc, vlen_slot, offs, chunk_kv=32)
    packed = packed_mixed_attention(tqf, kc, vc, tseg, tvl, tqo,
                                    chunk_kv=32)
    for tok, w in enumerate(where):
        if w is not None:
            assert torch.equal(packed[tok, 0], padded[w]), (tok, w)


# ---------------------------------------------------------------------------
# model forward
# ---------------------------------------------------------------------------

MAX_LEN, MBS, SLOTS = 64, 16, 2


def _model_steps(vocab, seed):
    """Two mixed steps of 2 slots: prefill chunks, then a decode beside a
    continuing prefill; per step (tokens, cache_len, n_new)."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, vocab, (SLOTS, 8)).astype(np.int32)
            for _ in range(2)]
    return list(zip(toks, [np.array([0, 0], np.int32),
                           np.array([8, 5], np.int32)],
                    [np.array([8, 5], np.int32), np.array([1, 3],
                                                         np.int32)]))


def _paged_meta(cache_len, n_new, s, nb):
    nblk = MAX_LEN // MBS
    tables = np.arange(SLOTS * nblk, dtype=np.int32).reshape(SLOTS, nblk)
    pos = cache_len[:, None] + np.arange(s)[None]
    smap = tables[np.arange(SLOTS)[:, None], pos // MBS] * MBS + pos % MBS
    smap = np.where(np.arange(s)[None] < n_new[:, None], smap,
                    nb * MBS).astype(np.int32)
    return tables, smap


def _flat(grid, cache_len, n_new, smap, nb):
    """A fake engine's ``_flatten_grid`` of one padded step."""
    fake = types.SimpleNamespace(
        slots=SLOTS, block_size=MBS, cache_len=cache_len,
        pool=types.SimpleNamespace(num_blocks=nb))
    return ServeEngine._flatten_grid(fake, grid, n_new, smap)


def _run_port(cfg, tp, steps, packed, paged):
    nb = SLOTS * (MAX_LEN // MBS + 1)
    caches = tfm.init_paged_caches(cfg, SLOTS, nb, MBS, "cpu") if paged \
        else tfm.init_caches(cfg, SLOTS, MAX_LEN, "cpu")
    outs = []
    for toks, cl, nn in steps:
        tables, smap = _paged_meta(cl, nn, toks.shape[1], nb)
        kw = dict(block_tables=torch.from_numpy(tables)) if paged else {}
        if not packed:
            if paged:
                kw["slot_map"] = torch.from_numpy(smap)
            h, caches, _ = tfm.forward(
                tp, cfg, {"tokens": torch.from_numpy(toks)}, mode="mixed",
                caches=caches, cache_len=torch.from_numpy(cl),
                n_new=torch.from_numpy(nn), **kw)
            outs.append([h[i, j] for i in range(SLOTS)
                         for j in range(int(nn[i]))])
            continue
        flat, seg, pos, fnn, fsmap, _, _ = _flat(toks, cl, nn, smap, nb)
        if paged:
            kw["slot_map"] = torch.from_numpy(fsmap)
        h, caches, _ = tfm.forward(
            tp, cfg, {"tokens": torch.from_numpy(flat)}, mode="mixed",
            caches=caches, cache_len=torch.from_numpy(pos),
            n_new=torch.from_numpy(fnn), seg_ids=torch.from_numpy(seg), **kw)
        outs.append([h[t, 0] for t in range(int(nn.sum()))])
    return outs


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_packed_forward_equals_padded(kv, paged):
    _, _, cfg, tp = build("chatglm3-6b", POLICIES["int4_packed"][0], kv,
                          chunk_kv=32)
    steps = _model_steps(cfg.vocab_size, 1)
    padded = _run_port(cfg, tp, steps, packed=False, paged=paged)
    packed = _run_port(cfg, tp, steps, packed=True, paged=paged)
    for a, b in zip(padded, packed):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_packed_forward_matches_reference_weight_only(kv):
    jcfg, jp, cfg, tp = build("chatglm3-6b", dict(act_mode="none"), kv,
                              chunk_kv=32)
    steps = _model_steps(cfg.vocab_size, 2)
    nb = SLOTS * (MAX_LEN // MBS + 1)
    caches = jtfm.init_paged_caches(jcfg, SLOTS, nb, MBS)
    ref = []
    for toks, cl, nn in steps:
        tables, smap = _paged_meta(cl, nn, toks.shape[1], nb)
        flat, seg, pos, fnn, fsmap, _, _ = _flat(toks, cl, nn, smap, nb)
        h, caches, _ = jtfm.forward(
            jp, jcfg, {"tokens": jnp.asarray(flat)}, mode="mixed",
            caches=caches, cache_len=jnp.asarray(pos),
            n_new=jnp.asarray(fnn), block_tables=jnp.asarray(tables),
            slot_map=jnp.asarray(fsmap), seg_ids=jnp.asarray(seg))
        lg = np.asarray(jtfm.logits(jp, jcfg, h).astype(jnp.float32))
        ref.append(lg[:int(nn.sum()), 0, :cfg.vocab_size])
    ours = _run_port(cfg, tp, steps, packed=True, paged=True)
    for r, hs in zip(ref, ours):
        lg = tfm.logits(tp, cfg, torch.stack(hs)[:, None]).float().numpy()
        assert np.abs(lg[:, 0, :cfg.vocab_size] - r).max() <= 0.0625


# ---------------------------------------------------------------------------
# _flatten_grid
# ---------------------------------------------------------------------------

GRIDS = {
    # name: (cache_len, n_new) of 4 slots x chunk 8
    "decode_only": ([5, 9, 0, 17], [1, 1, 0, 1]),
    "mixed": ([0, 31, 8, 2], [8, 1, 3, 0]),
    "single_token": ([0, 0, 12, 0], [0, 0, 1, 0]),
    "full": ([0, 8, 16, 24], [8, 8, 8, 8]),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_flatten_grid_matches_reference(name):
    cl, nn = (np.asarray(a, np.int32) for a in GRIDS[name])
    slots, chunk, nb, bs = 4, 8, 13, 16
    rng = np.random.default_rng(len(name))
    grid = rng.integers(0, 100, (slots, chunk)).astype(np.int32)
    smap = rng.integers(0, nb * bs, (slots, chunk)).astype(np.int32)
    fake = types.SimpleNamespace(slots=slots, block_size=bs, cache_len=cl,
                                 pool=types.SimpleNamespace(num_blocks=nb))
    ours = ServeEngine._flatten_grid(fake, grid, nn, smap)
    ref = JServeEngine._flatten_grid(fake, grid, nn, smap)
    assert ours[-1] == ref[-1]                  # the bucket
    for a, b in zip(ours[:-1], ref[:-1]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", list(POLICIES))
def test_packed_engine_tokens_match_padded_and_reference(policy):
    """``packed=True`` gives every request the padded engine's tokens,
    on fewer grid rows; both follow the reference's oracle rollout up
    to its first near-tie."""
    pol, kv = POLICIES[policy]
    jcfg, jp, cfg, tp = build("chatglm3-6b", pol, kv)
    jcfg = _oracle_cfg(jcfg)
    prompts = _prompts(cfg.vocab_size, seed=sum(map(ord, policy)))
    eng_pad, padded = _serve(cfg, tp, prompts)
    reset_launch_counts()
    eng_pk, packed = _serve(cfg, tp, prompts, packed=True)
    assert not any(launch_counts().values())      # CPU: plain versions
    assert packed == padded
    st_pad, st_pk = eng_pad.stats(), eng_pk.stats()
    assert st_pk["scheduled_tokens"] == st_pad["scheduled_tokens"]
    assert st_pk["grid_tokens"] < st_pad["grid_tokens"]
    assert st_pk["d2h_fetches"] <= st_pk["steps"]
    tie = _near_tie(jcfg)
    compared = 0
    for uid, p in enumerate(prompts):
        ref, margins = chunked_oracle(jp, jcfg, p, len(packed[uid]))
        compared += _agree_until_near_tie(packed[uid], ref, margins, tie)
        if uid == 0 and kv == "bfloat16":
            roll = reference_rollout(jp, jcfg, p, len(packed[uid]), MAX_LEN)
            _agree_until_near_tie(packed[uid], roll, margins, tie)
    assert 3 * compared >= sum(map(len, packed.values())), compared


def test_packed_engine_paged_scan_route():
    """attn_chunk_kv < max_len: the packed step's attention runs the
    packed-query plain scan (the kernel's plain version)."""
    pol, kv = POLICIES["ternary_asym_int8kv"]
    _, _, cfg, tp = build("chatglm3-6b", pol, kv, chunk_kv=32)
    prompts = _prompts(cfg.vocab_size, seed=9)
    _, padded = _serve(cfg, tp, prompts)
    _, packed = _serve(cfg, tp, prompts, packed=True)
    assert packed == padded


def test_packed_step_inputs_never_alias_host_state():
    pol, kv = POLICIES["ternary_dense"]
    _, _, cfg, tp = build("granite-34b", pol, kv)
    eng = ServeEngine(tp, cfg, batch_slots=2, max_len=MAX_LEN, chunk=8,
                      packed=True, device="cpu")
    seen = []
    inner = eng._step

    def spy(params, batch, caches, *sched):
        seen.append([batch["tokens"], *sched])
        return inner(params, batch, caches, *sched)

    eng._step = spy
    for uid, p in enumerate(_prompts(cfg.vocab_size, seed=1)[:2]):
        eng.submit(Request(uid, p, 2))
    eng.step()
    assert len(seen[0]) == 7          # tokens + the packed step's 6 arrays
    before = [t.clone() for t in seen[0]]
    eng.cache_len += 7
    eng.block_tables.fill(3)
    for t, b in zip(seen[0], before):
        assert torch.equal(t, b)
        for a in (eng.cache_len, eng.block_tables):
            lo = a.__array_interface__["data"][0]
            assert not (lo <= t.data_ptr() < lo + a.nbytes)

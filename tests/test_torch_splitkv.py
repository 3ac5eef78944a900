"""Port parity (split-KV paged attention, block size 64, f32) on the CPU.

The paged-attention kernel cuts each query row's table entries into
ranges (``kernels/paged_attention._split``), takes un-normalized
partials per range and merges them in ascending order by the
log-sum-exp identity.  A CUDA kernel cannot run here, so these tests
hold that algorithm on the plain versions, which they leave unchanged:

* (a) ``paged_attention_partials_plain`` over each range of entries
  (the range as ``entry_valid``), merged by a sequential ascending merge
  written as the kernel's merge is (empty ranges skipped) and by
  ``distrib/decode_attn._lse_merge``, equals the unsplit
  ``paged_attention_plain`` at block_size 16 and 64;
* (b) the same inputs through the reference's ``paged_attention_pallas``
  in interpret mode (as tests/test_paged_attention_kernel.py runs it)
  agree with the port's plain versions at block_size 64 and f32, for
  the normalized route and the compacted partials;
* (c) ``ServeEngine(block_size=64, device="cpu")`` with ``max_len`` above
  ``attn_chunk_kv`` (so attention runs the paged scan, the kernel's
  plain version) agrees with ``tests/_serve_ref.py::reference_rollout``.

Tolerance: (a) and (b) are f32 throughout and sum in other orders, so
they agree to f32 rounding (2e-5, relative and absolute, as
tests/test_torch_distrib.py); (c) holds greedy tokens up to the first
near-tie of the reference's logits, as tests/test_torch_engine.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from _serve_ref import reference_rollout  # noqa: E402
from test_torch_engine import (POLICIES, _agree_until_near_tie,  # noqa: E402
                               _near_tie, _prompts, chunked_oracle)
from test_torch_model import build  # noqa: E402

from repro.kernels.paged_attention import paged_attention_pallas  # noqa: E402,E501

from repro_torch.distrib import decode_attn as da  # noqa: E402
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
B, SQ, H, HK, D = 3, 4, 8, 2, 16
NEG_INF = np.float32(-1e30)


def _data(bs, positions=1024, seed=0):
    """3 slots: a long cache (several ranges), one with unassigned
    entries past its length, one with nothing valid; f32 throughout."""
    rng = np.random.default_rng(seed + bs)
    nblk = positions // bs
    nb = B * nblk + 3
    q = rng.standard_normal((B, SQ, H, D)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, HK, D)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, HK, D)).astype(np.float32)
    tbl = rng.permutation(nb)[:B * nblk].reshape(B, nblk).astype(np.int32)
    vlen = np.array([positions - 37, positions // 3, 0], np.int32)
    tbl[1, -(-int(vlen[1]) // bs):] = -1
    qoff = np.maximum(vlen - SQ, 0).astype(np.int32)
    return q, kp, vp, tbl, vlen, qoff


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def kernel_order_merge(parts):
    """The merge as paged_merge_kernel takes it: ranges in ascending
    order, a range with nothing valid (m == -1e30) skipped, both maxima
    clamped to -1e29, f32 throughout.  parts: [(o, m, l)] per range."""
    m_all = torch.stack([m for _, m, _ in parts])
    big = m_all.amax(dim=0)
    big_s = big.clamp(min=-1e29)
    o_acc = torch.zeros_like(parts[0][0])
    l_acc = torch.zeros_like(parts[0][1])
    for o, m, l in parts:
        c = torch.exp(m.clamp(min=-1e29) - big_s)
        c = torch.where(m == NEG_INF, torch.zeros_like(c), c)
        l_acc = l_acc + c * l
        o_acc = o_acc + c[..., None] * o
    return o_acc, big, l_acc


def _range_partials(q, kp, vp, tbl, vlen, qoff, causal):
    """Each split-KV range's partials through the plain partials route:
    the full table, entry e valid iff it falls in the range."""
    nblk = tbl.shape[1]
    e_per, r = pk._split(nblk, kp.shape[1])
    ident = torch.arange(nblk, dtype=torch.int32).expand(B, nblk)
    parts = []
    for i in range(r):
        sel = ((ident >= i * e_per) & (ident < (i + 1) * e_per)).to(
            torch.int32)
        parts.append(pk.paged_attention_partials_plain(
            q, kp, vp, tbl, vlen, q_offset=qoff if causal else None,
            causal=causal, logical_blocks=ident, entry_valid=sel))
    return parts, r


@pytest.mark.parametrize("nblk,bs", [(128, 16), (32, 64), (2048, 16),
                                     (7, 64), (1, 1), (300, 3)])
def test_split_ranges_cover_the_table(nblk, bs):
    e, r = pk._split(nblk, bs)
    assert 1 <= r <= pk.MAX_RANGES
    assert (r - 1) * e < nblk <= r * e
    assert e * bs >= pk.RANGE_POSITIONS or r == 1
    # the same table width and block size give the same ranges, whatever
    # the batch: a packed token and its padded-grid row share them
    assert pk._split(nblk, bs) == (e, r)


@pytest.mark.parametrize("causal", [True, False], ids=["mixed", "decode"])
@pytest.mark.parametrize("bs", [16, 64])
def test_range_partials_merge_to_unsplit_attention(bs, causal):
    q, kp, vp, tbl, vlen, qoff = _t(*_data(bs))
    parts, r = _range_partials(q, kp, vp, tbl, vlen, qoff, causal)
    assert r > 1, "the case must cross a range boundary"
    want = pk.paged_attention_plain(q, kp, vp, tbl, vlen,
                                    q_offset=qoff if causal else 0,
                                    chunk_kv=4 * bs, causal=causal)
    o, m, l = kernel_order_merge(parts)
    got = (o / l.clamp(min=1e-30)[..., None]).movedim(3, 1).reshape(
        want.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert not got[2].any()
    # the sharded path's merge of the same partials agrees
    st = [torch.stack(x) for x in zip(*[(m_, l_, o_) for o_, m_, l_
                                        in parts])]
    lse = da._lse_merge(*st, torch.float32, da.stacked_reduce)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), **TOL)
    # merged partials: the raw max, and l, o under it
    full = pk.paged_attention_partials_plain(
        q, kp, vp, tbl, vlen, q_offset=qoff if causal else None,
        causal=causal, logical_blocks=torch.arange(tbl.shape[1]).expand(
            B, -1), entry_valid=torch.ones_like(tbl))
    for a, b in zip((o, m, l), full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert (m[2] == NEG_INF).all() and not l[2].any()


@pytest.mark.parametrize("causal", [True, False], ids=["mixed", "decode"])
def test_block64_f32_matches_reference_kernel(causal):
    q, kp, vp, tbl, vlen, qoff = _data(64, positions=256, seed=5)
    ref = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(vlen), q_offset=jnp.asarray(qoff) if causal else 0,
        chunk_kv=128, causal=causal, interpret=True)
    tq, tk, tv, tt, tvl, tqo = _t(q, kp, vp, tbl, vlen, qoff)
    got = pk.paged_attention_plain(tq, tk, tv, tt, tvl, chunk_kv=128,
                                   q_offset=tqo if causal else 0,
                                   causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # and through the split-KV ranges of the kernel
    parts, _ = _range_partials(tq, tk, tv, tt, tvl, tqo, causal)
    o, _, l = kernel_order_merge(parts)
    split = (o / l.clamp(min=1e-30)[..., None]).movedim(3, 1).reshape(
        got.shape)
    np.testing.assert_allclose(split.numpy(), np.asarray(ref), **TOL)


def test_block64_f32_partials_match_reference_kernel():
    """The compacted partials (a shard's local-first table) at
    block_size 64, f32."""
    q, kp, vp, tbl, vlen, qoff = _data(64, positions=256, seed=9)
    nb_loc = kp.shape[0] // 2 + 1
    loc = (tbl >= 0) & (tbl < nb_loc)
    keep = np.argsort(~loc, axis=1, kind="stable").astype(np.int32)
    sel = np.take_along_axis(loc, keep, 1).astype(np.int32)
    gid = np.clip(np.take_along_axis(tbl, keep, 1), 0, nb_loc - 1).astype(
        np.int32)
    kl, vl = kp[:nb_loc], vp[:nb_loc]
    jo, jm, jl = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kl), jnp.asarray(vl), jnp.asarray(gid),
        jnp.asarray(vlen), q_offset=jnp.asarray(qoff), chunk_kv=64,
        causal=True, logical_blocks=jnp.asarray(keep),
        entry_valid=jnp.asarray(sel), normalize=False, interpret=True)
    to, tm, tl = pk.paged_attention_partials_plain(
        *_t(q, kl, vl, gid, vlen), q_offset=torch.from_numpy(qoff),
        causal=True, logical_blocks=torch.from_numpy(keep),
        entry_valid=torch.from_numpy(sel))
    for got, ref in ((to, jo), (tm, jm), (tl, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert (tm[2] == NEG_INF).all() and not tl[2].any()


def test_block64_engine_matches_reference_rollout():
    """block_size 64 with max_len 128 above attn_chunk_kv = 64: every
    table spans two blocks, so attention takes the paged scan."""
    pol, kv = POLICIES["ternary_dense"]
    jcfg, jp, cfg, tp = build("chatglm3-6b", pol, kv, chunk_kv=64)
    prompts = _prompts(cfg.vocab_size, seed=64)
    new, max_len = 4, 128
    eng = ServeEngine(tp, cfg, batch_slots=2, max_len=max_len, chunk=8,
                      block_size=64, device="cpu")
    assert eng.block_tables.shape[1] * 64 > cfg.attn_chunk_kv
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, new))
    while eng.queue or eng._active_slots():
        eng.step()
        eng.validate()
    got = {r.uid: r.out_tokens for r in eng.finished}
    tie = _near_tie(jcfg)
    compared = 0
    for uid, p in enumerate(prompts):
        roll = reference_rollout(jp, jcfg, p, new, max_len)
        _, margins = chunked_oracle(jp, jcfg, p, new)
        compared += _agree_until_near_tie(got[uid], roll, margins, tie)
    assert 3 * compared >= new * len(prompts), compared
    assert eng.stats()["finished_requests"] == len(prompts)

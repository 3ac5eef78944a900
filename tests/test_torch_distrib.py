"""Port parity (distrib): the sharded attention of
``repro_torch.distrib.decode_attn`` and the plain version of the
compacted-partials kernel against the JAX reference, on the CPU.

* ``paged_attention_partials_plain`` (the plain version of the port's
  ``paged_attention_pallas(normalize=False, logical_blocks=,
  entry_valid=)``) against that Pallas kernel in interpret mode and
  against the reference's ``_local_partial``, on every shard's
  numpy-built local-first compaction of one table.
* The sharded functions at world sizes 2 and 4: one process per rank
  (``tests/_torch_distrib_worker.py``, gloo, a ``file://`` store under
  the test's tmp dir, a 60 s collective timeout and a join timeout),
  their merged outputs against the reference's unsharded oracles
  computed here.  The cases cover decode, ragged mixed and packed
  queries, a slot all of whose blocks sit on one shard (so every other
  shard owns none of it) and a table longer than a shard (the
  compaction bound binds).
* The same paged cases with the n shards' partials computed in one
  process and merged by ``_lse_merge`` with ``stacked_reduce`` (the
  route ``chip_smoke.py`` takes on one card).
* ``nn.attention.decode_attention`` against the reference's.

Tolerance: everything is f32 and the two frameworks sum in other
orders, so outputs agree to f32 rounding; 2e-5 (relative and absolute)
is what tests/test_distrib_multidev.py holds the reference's own
sharded routes to.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.distrib import decode_attn as jda  # noqa: E402
from repro.kernels.paged_attention import paged_attention_pallas  # noqa: E402,E501
from repro.nn.attention import decode_attention as j_decode  # noqa: E402

from repro_torch.distrib import decode_attn as da  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.nn.attention import decode_attention  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# ---------------------------------------------------------------------------
# shared inputs (the reference's multi-device test shapes)
# ---------------------------------------------------------------------------

B, S, H, HK, D = 2, 32, 8, 4, 16
SQ = 4
BS, NBLK, NB = 8, 4, 16          # 32 logical positions over 16 blocks


def _data():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    d = dict(q=f(B, 1, H, D), qm=f(B, SQ, H, D), k=f(B, S, HK, D),
             v=f(B, S, HK, D), pk=f(NB, BS, HK, D), pv=f(NB, BS, HK, D),
             q_long=f(1, 2, H, D))
    d["clen"] = np.array([9, 27], np.int32)
    d["offs"] = np.array([5, 23], np.int32)       # per-slot write offsets
    d["nnew"] = np.array([4, 3], np.int32)        # slot 1: ragged chunk
    # slot 0's blocks all lie in [0, 4): on shard 0 at world 2 and 4, so
    # every other shard owns none of them
    d["tbl"] = np.stack([np.array([2, 0, 3, 1]),
                         4 + rng.permutation(12)[:NBLK]]).astype(np.int32)
    # 8 logical blocks > nb_loc = 16 / 4: each shard keeps its compacted
    # local slice only
    d["tbl_long"] = rng.permutation(NB)[:8].reshape(1, 8).astype(np.int32)
    d["off_long"] = np.array([50], np.int32)
    # the mixed step's tokens flattened, plus one bucket-padding token
    seg, vlen, qoff, where = [], [], [], []
    for i in range(B):
        for j in range(int(d["nnew"][i])):
            seg.append(i)
            vlen.append(int(d["offs"][i]) + j + 1)
            qoff.append(int(d["offs"][i]) + j)
            where.append((i, j))
    seg.append(-1)
    vlen.append(0)
    qoff.append(0)
    q_flat = np.zeros((len(seg), 1, H, D), np.float32)
    for t, (i, j) in enumerate(where):
        q_flat[t, 0] = d["qm"][i, j]
    d.update(q_flat=q_flat, seg=np.array(seg, np.int32),
             vlen_flat=np.array(vlen, np.int32),
             qoff_flat=np.array(qoff, np.int32))
    return d, where


DATA, WHERE = _data()


def _j(name):
    return jnp.asarray(DATA[name])


def _oracles():
    """The reference's unsharded oracles, per case: (want, rows) with
    ``rows`` the (slot, query) rows to compare."""
    vlen = _j("offs") + _j("nnew")
    nnew = DATA["nnew"]
    mixed_rows = [(i, j) for i in range(B) for j in range(int(nnew[i]))]
    want_p = jda.reference_paged_mixed_attention(
        _j("qm"), _j("pk"), _j("pv"), _j("tbl"), vlen, _j("offs"))
    packed = np.zeros(DATA["q_flat"].shape, np.float32)
    for t, (i, j) in enumerate(WHERE):
        packed[t, 0] = np.asarray(want_p)[i, j]      # padding token: 0
    return {
        "decode": (jda.reference_decode_attention(
            _j("q"), _j("k"), _j("v"), _j("clen")), None),
        "mixed": (jda.reference_mixed_attention(
            _j("qm"), _j("k"), _j("v"), vlen, _j("offs")), mixed_rows),
        "paged_mixed": (want_p, mixed_rows),
        "paged_decode": (jda.reference_paged_mixed_attention(
            _j("q"), _j("pk"), _j("pv"), _j("tbl"), _j("clen"),
            _j("clen") - 1), None),
        "paged_long": (jda.reference_paged_mixed_attention(
            _j("q_long"), _j("pk"), _j("pv"), _j("tbl_long"),
            _j("off_long") + 2, _j("off_long")), None),
        "paged_packed": (packed, None),
    }


CASES = ["decode", "mixed", "paged_mixed", "paged_decode", "paged_long",
         "paged_packed"]
PAGED = [c for c in CASES if c.startswith("paged")]


@pytest.fixture(scope="module")
def oracles():
    return _oracles()


def _check(got, want, rows):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if rows is None:
        np.testing.assert_allclose(got, want, **TOL)
    else:  # rows past a slot's new tokens are not defined by the oracle
        for i, j in rows:
            np.testing.assert_allclose(got[i, j], want[i, j], **TOL)


# ---------------------------------------------------------------------------
# the sharded functions under gloo, one process per rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def gloo_outputs(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gloo{world}")
    data = tmp / "data.npz"
    np.savez(data, **DATA)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_distrib_worker.py"),
         str(r), str(world), str(tmp / "store"), str(data),
         str(tmp / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=180)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"world {world}: a rank did not finish in 180 s")
    bad = [(r, p.returncode, log) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad
    return world, [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("case", CASES)
def test_gloo_sharded_matches_reference(gloo_outputs, oracles, case):
    world, outs = gloo_outputs
    want, rows = oracles[case]
    for rank in range(world):         # the merged output is replicated
        _check(outs[rank][case], want, rows)


# ---------------------------------------------------------------------------
# n shards' partials in one process, merged with a stacked reduce
# ---------------------------------------------------------------------------

def _paged_args(case):
    t = {k: torch.from_numpy(v) for k, v in DATA.items()}
    vlen = t["offs"] + t["nnew"]
    if case == "paged_mixed":
        return t["qm"], t["tbl"], vlen, t["offs"]
    if case == "paged_decode":
        return t["q"], t["tbl"], t["clen"], None
    if case == "paged_long":
        return t["q_long"], t["tbl_long"], t["off_long"] + 2, t["off_long"]
    seg = t["seg"].long().clamp(0, B - 1)
    return t["q_flat"], t["tbl"][seg], t["vlen_flat"], t["qoff_flat"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", PAGED)
def test_stacked_merge_matches_reference(oracles, case, n):
    q, tbl, vlen, qoff = _paged_args(case)
    nb_loc = NB // n
    parts = [da.paged_shard_partial(
        q, torch.from_numpy(DATA["pk"][r * nb_loc:(r + 1) * nb_loc]),
        torch.from_numpy(DATA["pv"][r * nb_loc:(r + 1) * nb_loc]), tbl,
        vlen, r, qoff) for r in range(n)]
    m, l, o = (torch.stack(x) for x in zip(*parts))
    got = da._lse_merge(m, l, o, q.dtype, da.stacked_reduce)
    _check(got, *oracles[case])


def test_sharded_rejects_unknown_impl():
    q, tbl, vlen, qoff = _paged_args("paged_mixed")
    with pytest.raises(ValueError):
        da.paged_shard_partial(q, torch.from_numpy(DATA["pk"]),
                               torch.from_numpy(DATA["pv"]), tbl, vlen, 0,
                               qoff, impl="pallas")


# ---------------------------------------------------------------------------
# the compacted partials against the Pallas kernel and _local_partial
# ---------------------------------------------------------------------------

N_SHARDS = 4
PB, PSQ, PNBLK, PNB = 3, 2, 6, 24     # 6 logical blocks, 6 per shard


def _partials_data():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(PB, PSQ, H, D)).astype(np.float32)
    kp = rng.normal(size=(PNB, BS, HK, D)).astype(np.float32)
    vp = rng.normal(size=(PNB, BS, HK, D)).astype(np.float32)
    tbl = rng.permutation(PNB)[:PB * PNBLK].reshape(PB, PNBLK)
    tbl[1, 5] = -1                    # an unassigned entry
    vlen = np.array([45, 33, 0], np.int32)     # slot 2: nothing valid
    return (q, kp, vp, tbl.astype(np.int32), vlen,
            np.maximum(vlen - PSQ, 0))


def _np_compact(tbl, base, nb_loc):
    """Local entries first, stable, cut to min(nblk, nb_loc)."""
    loc = (tbl >= base) & (tbl < base + nb_loc)
    keep = np.argsort(~loc, axis=1, kind="stable")[:, :min(tbl.shape[1],
                                                           nb_loc)]
    sel = np.take_along_axis(loc, keep, 1)
    gid = np.clip(np.take_along_axis(tbl, keep, 1) - base, 0, nb_loc - 1)
    return keep.astype(np.int32), sel.astype(np.int32), gid.astype(np.int32)


@pytest.mark.parametrize("chunk", ["one", "per_block"])
@pytest.mark.parametrize("causal", [True, False], ids=["mixed", "decode"])
@pytest.mark.parametrize("shard", range(N_SHARDS))
def test_partials_plain_match_reference(shard, causal, chunk):
    q, kp, vp, tbl, vlen, qoff = _partials_data()
    if not causal:                    # decode: one query, validity only
        q = q[:, :1]
    nb_loc = PNB // N_SHARDS
    base = shard * nb_loc
    keep, sel, gid = _np_compact(tbl, base, nb_loc)
    kl, vl = kp[base:base + nb_loc], vp[base:base + nb_loc]
    l_loc = keep.shape[1]
    jo, jm, jl = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kl), jnp.asarray(vl), jnp.asarray(gid),
        jnp.asarray(vlen), q_offset=jnp.asarray(qoff if causal else 0 * qoff),
        chunk_kv=l_loc * BS if chunk == "one" else BS, causal=causal,
        logical_blocks=jnp.asarray(keep), entry_valid=jnp.asarray(sel),
        normalize=False, interpret=True)
    kpos = (keep[:, :, None] * BS + np.arange(BS)).reshape(PB, -1)
    lm, ll, lo = jda._local_partial(
        jnp.asarray(q), jnp.asarray(kl[gid].reshape(PB, -1, HK, D)),
        jnp.asarray(vl[gid].reshape(PB, -1, HK, D)), 0, jnp.asarray(vlen),
        jnp.asarray(qoff) if causal else None, kpos=jnp.asarray(kpos),
        extra_valid=jnp.asarray(np.repeat(sel > 0, BS, axis=1)))
    tq = torch.from_numpy(q)
    tqoff = torch.from_numpy(qoff) if causal else None
    to, tm, tl = pk.paged_attention_partials_plain(
        tq, torch.from_numpy(kl), torch.from_numpy(vl),
        torch.from_numpy(gid), torch.from_numpy(vlen), q_offset=tqoff,
        causal=causal, logical_blocks=torch.from_numpy(keep),
        entry_valid=torch.from_numpy(sel))
    for got, ref_k, ref_l in ((to, jo, lo), (tm, jm, lm), (tl, jl, ll)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_k), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_l), **TOL)
    assert (tm[2] == np.float32(-1e30)).all() and not tl[2].any()
    # the port's own compaction feeds the same partials
    sm, sl, so = da.paged_shard_partial(
        tq, torch.from_numpy(kl), torch.from_numpy(vl),
        torch.from_numpy(tbl), torch.from_numpy(vlen), shard, tqoff)
    assert torch.equal(so, to) and torch.equal(sm, tm) and \
        torch.equal(sl, tl)


def test_partials_cpu_dispatch_runs_plain_and_counts_nothing():
    q, kp, vp, tbl, vlen, qoff = (torch.from_numpy(a)
                                  for a in _partials_data())
    keep, sel, gid = (torch.from_numpy(a) for a in _np_compact(
        tbl.numpy(), 0, PNB))
    kw = dict(q_offset=qoff, causal=True, logical_blocks=keep,
              entry_valid=sel)
    reset_launch_counts()
    got = pk.paged_attention_partials(q, kp, vp, gid, vlen, **kw)
    want = pk.paged_attention_partials_plain(q, kp, vp, gid, vlen, **kw)
    assert launch_counts()["paged_attention_partials"] == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,hk,d,clen", [
    (2, 32, 8, 4, 16, [9, 27]),
    (3, 20, 4, 1, 8, [1, 20, 7]),
])
def test_decode_attention_matches_reference(b, s, h, hk, d, clen):
    rng = np.random.default_rng(s)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    cl = np.array(clen, np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(cl))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

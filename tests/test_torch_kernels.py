"""Port parity (kernels): the plain versions of the TiM matmul and paged
attention kernels against the JAX reference.  The Hopper kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py).

TiM matmul: scales are dyadic (k/8) and the int-activation step is
0.25, so every f32 product and sum is exact and the plain version must
equal the reference bit for bit — against ``impl='xla'`` (two-phase:
its ``fused=False`` route, which rounds each phase to the output dtype
as the Pallas kernel does) and against the Pallas kernels run in
interpret mode.

Paged attention: f32 scores/softmax in another reduction order than
XLA's, then one rounding to bf16, so outputs agree to about one bf16
ulp: |diff| <= 2^-7 * |ref| + 2e-3 is asserted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (the reference engine's tests are timing-
# sensitive under this jax version, ROADMAP R1)
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core.ternary import TernaryScales as JScales  # noqa: E402
from repro.core.weights import TernaryWeight as JTW  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.paged_attention import paged_attention_pallas  # noqa: E402,E501
from repro.models.transformer import _kv_quantize as j_kv_quantize  # noqa: E402,E501
from repro.nn.attention import _paged_chunked_attention as j_paged  # noqa: E402,E501

from repro_torch.core.packing import pack2b  # noqa: E402
from repro_torch.core.ternary import TernaryScales  # noqa: E402
from repro_torch.core.weights import TernaryWeight  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.models.transformer import _kv_quantize  # noqa: E402

M, K, N = 5, 44, 24


def _weights(k, n, encoding, pack, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, 2, (k, n)).astype(np.int8)
    pos = (rng.integers(1, 9, n) / 8).astype(np.float32)
    neg = pos if encoding == "symmetric" else \
        (rng.integers(1, 9, n) / 8).astype(np.float32)
    sym = encoding == "symmetric"
    qp = np.pad(q, ((0, (-k) % 4), (0, 0)))
    jdata = jpack.pack2b(jnp.asarray(qp), axis=0) if pack else jnp.asarray(q)
    jw = JTW(jdata, JScales(jnp.asarray(pos), jnp.asarray(neg), sym), pack, k)
    tdata = pack2b(torch.from_numpy(qp), axis=0) if pack \
        else torch.from_numpy(q)
    tw = TernaryWeight(tdata, TernaryScales(torch.from_numpy(pos),
                                            torch.from_numpy(neg), sym),
                       pack, k)
    return jw, tw


def _acts(act, seed):
    rng = np.random.default_rng(seed + 100)
    if act == "ternary":
        return rng.integers(-1, 2, (M, K)).astype(np.int8), None
    bits = int(act[3:])
    return rng.integers(0, 1 << bits, (M, K)).astype(np.int8), bits


def _port(x, tw, bits, n_max, impl="auto", fused=True,
          out_dtype=torch.bfloat16):
    xt = torch.from_numpy(x)
    if bits is None:
        one = torch.tensor(1.0, dtype=torch.bfloat16)
        return ops.tim_matmul(xt, tw, TernaryScales(one, one, True),
                              n_max=n_max, impl=impl, fused=fused,
                              out_dtype=out_dtype)
    return ops.tim_matmul_bitserial(
        xt, torch.tensor(0.25, dtype=torch.bfloat16), tw, bits,
        n_max=n_max, impl=impl, fused=fused, out_dtype=out_dtype)


def _ref(x, jw, bits, n_max, impl, fused=True, out_dtype=jnp.bfloat16):
    xj = jnp.asarray(x)
    if bits is None:
        one = jnp.ones((), jnp.bfloat16)
        # the two-phase oracle of the reference that rounds each phase
        # to the output dtype (as the Pallas kernel and the port do)
        if impl == "xla" and not jw.scales.symmetric:
            fused = False
        return jops.tim_matmul(xj, jw, JScales(one, one, True), n_max=n_max,
                               impl=impl, fused=fused, out_dtype=out_dtype)
    return jops.tim_matmul_bitserial(
        xj, jnp.asarray(0.25, jnp.bfloat16), jw, bits, n_max=n_max,
        impl=impl, fused=fused, out_dtype=out_dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


MATRIX = [(enc, act, pack, n_max)
          for enc in ("symmetric", "asymmetric")
          for act in ("ternary", "int2", "int4")
          for pack in (False, True)
          for n_max in (None, 8)]


@pytest.mark.parametrize("enc,act,pack,n_max", MATRIX)
@pytest.mark.parametrize("fused", [True, False])
def test_tim_plain_matches_reference_xla(enc, act, pack, n_max, fused):
    jw, tw = _weights(K, N, enc, pack, seed=len(enc) + len(act))
    x, bits = _acts(act, seed=3)
    ours = _port(x, tw, bits, n_max, fused=fused)
    ref = _ref(x, jw, bits, n_max, "xla", fused=fused)
    np.testing.assert_array_equal(_np(ours), _np(ref))


@pytest.mark.parametrize("enc,act,pack,n_max", MATRIX)
def test_tim_plain_matches_reference_pallas(enc, act, pack, n_max):
    jw, tw = _weights(K, N, enc, pack, seed=7)
    x, bits = _acts(act, seed=5)
    ours = _port(x, tw, bits, n_max)
    ref = _ref(x, jw, bits, n_max, "pallas")
    np.testing.assert_array_equal(_np(ours), _np(ref))


@pytest.mark.parametrize("enc", ["symmetric", "asymmetric"])
@pytest.mark.parametrize("n_max", [None, 8])
def test_tim_plain_matches_dense_oracle(enc, n_max):
    _, tw = _weights(K, N, enc, True, seed=11)
    x, _ = _acts("ternary", seed=2)
    ours = _port(x, tw, None, n_max, out_dtype=torch.float32)
    oracle = _port(x, tw, None, n_max, impl="ref", out_dtype=torch.float32)
    np.testing.assert_allclose(_np(ours), _np(oracle), rtol=1e-6,
                               atol=1e-6)


def test_tim_route_torch_equals_auto_on_cpu():
    _, tw = _weights(K, N, "asymmetric", True, seed=1)
    x, bits = _acts("int4", seed=1)
    reset_launch_counts()
    a = _port(x, tw, bits, None)
    b = _port(x, tw, bits, None, impl="torch")
    assert torch.equal(a, b)
    # CPU tensors take the plain version: no kernel launch is counted
    assert not any(launch_counts().values())


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("asym", [False, True])
def test_weight_stream_stats_match_reference(bits, asym):
    enc = "asymmetric" if asym else "symmetric"
    jw, tw = _weights(64, 32, enc, True, seed=0)
    for m in (1, 128, 300):
        for fused in (True, False):
            assert ops.weight_stream_stats(m, tw, bits=bits, fused=fused) \
                == jops.weight_stream_stats(m, jw, bits=bits, fused=fused)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

B, SQ, H, HK, D, BS, NBLK, NB, CHUNK = 3, 4, 4, 2, 16, 16, 6, 20, 32


def _attn_inputs(seed, quant):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, SQ, H, D)).astype(np.float32)
    k = rng.standard_normal((NB, BS, HK, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, HK, D)).astype(np.float32)
    tbl = rng.permutation(NB)[:B * NBLK].reshape(B, NBLK).astype(np.int32)
    tbl[1, 3:] = -1                       # unassigned entries
    n_new = np.array([4, 1, 0], np.int32)
    vlen = np.array([70, 33, 0], np.int32)   # slot 2: fully masked
    qoff = vlen - n_new
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    jk = jnp.asarray(k).astype(jnp.bfloat16)
    jv = jnp.asarray(v).astype(jnp.bfloat16)
    tq = torch.from_numpy(q).bfloat16()
    tkk = torch.from_numpy(k).bfloat16()
    tv = torch.from_numpy(v).bfloat16()
    jkw, tkw = {}, {}
    if quant:
        jk, jks = j_kv_quantize(jk)
        jv, jvs = j_kv_quantize(jv)
        tkk, tks = _kv_quantize(tkk)
        tv, tvs = _kv_quantize(tv)
        jkw = dict(k_scale=jks, v_scale=jvs)
        tkw = dict(k_scale=tks, v_scale=tvs)
    j = (jq, jk, jv, jnp.asarray(tbl), jnp.asarray(vlen), jnp.asarray(qoff))
    t = (tq, tkk, tv, torch.from_numpy(tbl), torch.from_numpy(vlen),
         torch.from_numpy(qoff))
    return j, jkw, t, tkw


def _close(ours, ref):
    o, r = _np(ours), _np(ref)
    assert np.isfinite(o).all()
    assert (np.abs(o - r) <= np.abs(r) * 2.0 ** -7 + 2e-3).all(), \
        np.abs(o - r).max()


def test_kv_quantize_bit_exact():
    (_, jk, _, *_), _, (_, tkk, *_), _ = _attn_inputs(0, False)
    jc, js = j_kv_quantize(jk)
    tc, ts = _kv_quantize(tkk)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(_np(js), _np(ts))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_paged_plain_matches_reference(quant, causal):
    j, jkw, t, tkw = _attn_inputs(1, quant)
    jq, jk, jv, jt, jvl, jqo = j
    tq, tkk, tv, tt, tvl, tqo = t
    ours = pk.paged_attention(tq, tkk, tv, tt, tvl, q_offset=tqo,
                              chunk_kv=CHUNK, causal=causal, **tkw)
    ref_xla = j_paged(jq, jk, jv, jt, causal, CHUNK, jqo, jvl,
                      impl="xla", **jkw)
    ref_pallas = paged_attention_pallas(jq, jk, jv, jt, jvl, q_offset=jqo,
                                        chunk_kv=CHUNK, causal=causal,
                                        interpret=True, **jkw)
    _close(ours, ref_xla)
    _close(ours, ref_pallas)
    # the fully masked slot comes out exactly 0, never NaN
    assert not _np(ours)[2].any()


def test_paged_plain_single_chunk_and_mixed_route():
    """Caches within one chunk take full_attention on the gathered view
    (as in the reference); larger ones the paged scan — both through
    ``mixed_attention``."""
    from repro.nn.attention import mixed_attention as j_mixed
    from repro_torch.nn.attention import mixed_attention
    j, _, t, _ = _attn_inputs(2, False)
    jq, jk, jv, jt, jvl, jqo = j
    tq, tkk, tv, tt, tvl, tqo = t
    for chunk in (CHUNK, NBLK * BS):
        ours = mixed_attention(tq, tkk, tv, tvl, tqo, chunk_kv=chunk,
                               block_tables=tt)
        ref = j_mixed(jq, jk, jv, jvl, jqo, chunk_kv=chunk,
                      block_tables=jt, impl="xla")
        _close(ours, ref)

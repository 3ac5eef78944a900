"""The Hopper kernels against their plain PyTorch versions (CUDA card).

Imports only torch, numpy and the port, so it also runs on a machine
without JAX: ``python -m pytest -q -m cuda --noconftest
tests/test_torch_cuda.py``.  Without a card every test skips.

Tolerances: the TiM kernels equal their plain versions bit for bit
(exact int32 products, the same correctly rounded f32 epilogue), for
activation codes over the whole int8 range (|-128| and -(-128) wrap as
in int8, as in the Pallas kernels); paged
attention, mixed and packed, at block_size 16 and 64, agrees to about
one bf16 ulp (online softmax per 16 keys, split-KV ranges merged by the
lse identity, another summation order): |diff| <= 2^-7 * |ref| + 2e-3,
and with f32 queries to f32 rounding (2e-5).  The packed kernel equals
the mixed kernel bit for bit, token by token (the same ranges and the
same per-row arithmetic, Sq = 1).  The compacted partials
(o, m, l), f32, agree with their plain version to f32 rounding of the
scores: |dm| <= 1e-5 * |m| + 1e-5, |dl| and |do| <= 1e-4 * l (each p
term to ~1e-6, summed over at most l's worth of probability mass);
merged over shards they agree with the unsharded kernel within the
attention tolerance.  Flash attention: bf16 as paged attention, f32 to
2e-5 (relative and absolute).  Each test of the s8 tensor-core TiM
kernel and the wgmma flash kernel also checks, by the launch counters,
that the path the dispatch rule names served the call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.packing import pack2b  # noqa: E402
from repro_torch.distrib import decode_attn as da  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.kernels import tim_matmul as tk  # noqa: E402
from repro_torch.models.transformer import _kv_quantize  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.parametrize("mode,packed,need_t,bits", [
    ("single", False, False, 0), ("single", True, True, 0),
    ("phases", True, True, 0), ("phases", False, False, 0),
    ("bits", True, False, 4), ("bits", False, True, 2)])
@pytest.mark.parametrize("n_max", [None, 8])
def test_tim_kernel_equals_plain(dev, mode, packed, need_t, bits, n_max):
    gen = torch.Generator(device=dev).manual_seed(0)
    m, k, n = 70, 200, 130          # ragged against the 64x64x64 tiles
    lo, hi = (0, 1 << bits) if mode == "bits" else (-1, 2)
    x = torch.randint(lo, hi, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    wd = pack2b(w, axis=0) if packed else w
    w1 = torch.rand(n, generator=gen, device=dev)
    w2 = torch.rand(n, generator=gen, device=dev)
    isc = torch.rand(2 if mode == "phases" else 1, generator=gen,
                     device=dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        kw = dict(mode=mode, packed=packed, need_t=need_t, n_max=n_max,
                  bits=bits, out_dtype=out_dtype)
        out = tk.tim_st_launch(x, wd, w1, w2, isc, **kw)
        ref = tk.tim_st_plain(x, wd, w1, w2, isc, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def test_tim_wrapper_counts_and_rejects_bad_input(dev):
    x = torch.zeros((4, 8), dtype=torch.int8, device=dev)
    w = torch.zeros((8, 3), dtype=torch.int8, device=dev)
    s = torch.ones(3, device=dev)
    reset_launch_counts()
    tk.tim_matmul_single(x, w, s, s, torch.ones((), device=dev),
                         packed=False, need_t=False)
    assert launch_counts()["tim_single"] == 1
    with pytest.raises(ValueError):
        tk.tim_st_launch(x, w.t(), s, s, s[:1], mode="single", packed=False,
                         need_t=False)


# the s8 tensor-core kernel at its tile edges (128 rows, 128 columns and
# 128 K codes a tile): (M, K, N, K slices)
TC_CASES = [
    (1, 1040, 400, 9),        # one row; N and K not multiples of 128
    (70, 208, 256, 2),        # N = 256: K split into 2 slices
    (128, 4096, 256, 32),     # the served K/V projection shape
    (128, 1040, 8448, 1),     # 66 column tiles: the epilogue fused
    (70, 4096, 8448, 1),
    (200, 528, 4224, 1),      # M > 128: two row tiles, fused
    (128, 13696, 4096, 4),    # the served down projection
]


@pytest.mark.parametrize("need_t", [False, True])
@pytest.mark.parametrize("m,k,n,splits", TC_CASES)
def test_tim_tc_kernel_equals_plain(dev, m, k, n, splits, need_t):
    assert tk.tim_path("single", False, None, m, n, k,
                       need_t=need_t) == "tc"
    assert tk.tim_tc_splits(m, n, k, tk.sm_count(dev)) == splits
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    # activation codes over the whole int8 range, ternary weight codes
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    w1 = torch.rand(n, generator=gen, device=dev)
    w2 = torch.rand(n, generator=gen, device=dev)
    i1 = torch.rand((), generator=gen, device=dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        reset_launch_counts()
        out = tk.tim_matmul_single(x, w, w1, w2, i1, packed=False,
                                   need_t=need_t, out_dtype=out_dtype)
        counts = launch_counts()
        assert counts["tim_single"] == counts["tim_single_tc"] == 1
        ref = tk.tim_st_plain(x, w, w1, w2, i1.reshape(1), mode="single",
                              packed=False, need_t=need_t,
                              out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert out.dtype == out_dtype
        assert torch.equal(out, ref)


def test_tim_dp4a_path_serves_what_tc_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(-1, 2, (128, 200), generator=gen, device=dev,
                      dtype=torch.int8)                  # K % 16 != 0
    w = torch.randint(-1, 2, (200, 256), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand(256, generator=gen, device=dev)
    i1 = torch.ones((), device=dev)
    for n_max in (None, 8):
        reset_launch_counts()
        out = tk.tim_matmul_single(x, w, s, s, i1, packed=False,
                                   need_t=False, n_max=n_max)
        assert launch_counts()["tim_single"] == 1
        assert launch_counts()["tim_single_tc"] == 0
        ref = tk.tim_st_plain(x, w, s, s, i1.reshape(1), mode="single",
                              packed=False, need_t=False, n_max=n_max)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
    xm = torch.zeros(16 * 16 + 1, dtype=torch.int8, device=dev)[1:]
    with pytest.raises(ValueError):             # rows not 16-byte aligned
        tk.tim_st_launch(xm.view(16, 16), w[:16, :16].contiguous(),
                         s[:16], s[:16], i1.reshape(1), mode="single",
                         packed=False, need_t=False)


def _w_operand(gen, dev, k, n, packed):
    """Ternary codes, or packed bytes drawn at random, so that all four
    2-bit fields occur, the reserved 0b10 (decodes to 0) included."""
    if packed:
        return torch.randint(0, 256, (k // 4, n), generator=gen, device=dev,
                             dtype=torch.uint8)
    return torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                         dtype=torch.int8)


def _tim_call(mode, x, wd, w1, w2, isc, *, packed, need_t, n_max, bits,
              out_dtype):
    """The wrapper of ``mode`` (the one the engine calls) and its
    counter."""
    kw = dict(packed=packed, need_t=need_t, n_max=n_max,
              out_dtype=out_dtype)
    if mode == "single":
        return tk.tim_matmul_single(x, wd, w1, w2, isc[0], **kw), \
            "tim_single_packed" if packed else "tim_single"
    if mode == "phases":
        return tk.tim_matmul_fused(x, wd, w1, w2, isc[0], isc[1], **kw), \
            "tim_two_phase"
    return tk.tim_matmul_bitserial(x, wd, w1, w2, isc[0], bits=bits,
                                   **kw), "tim_bitserial"


def _tim_check(mode, x, wd, w1, w2, isc, *, packed, need_t, n_max=None,
               bits=0):
    """Every output type: the wrapper's launch equals the plain version
    bit for bit, one launch counted, on the path ``tim_path`` names."""
    m, k = x.shape
    path = tk.tim_path(mode, packed, n_max, m, wd.shape[1], k, need_t=need_t)
    for out_dtype in (torch.bfloat16, torch.float32):
        reset_launch_counts()
        out, counter = _tim_call(mode, x, wd, w1, w2, isc, packed=packed,
                                 need_t=need_t, n_max=n_max, bits=bits,
                                 out_dtype=out_dtype)
        counts = launch_counts()
        assert counts[counter] == 1
        for p in ("tc", "wgmma"):
            assert counts.get(f"{counter}_{p}", 0) == (path == p)
        ref = tk.tim_st_plain(x, wd, w1, w2, isc, mode=mode, packed=packed,
                              need_t=need_t, n_max=n_max, bits=bits,
                              out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert out.dtype == out_dtype
        assert torch.equal(out, ref)
    return path


@pytest.mark.parametrize("mode,packed", [
    ("single", False), ("single", True), ("phases", False),
    ("phases", True), ("bits", False), ("bits", True)])
@pytest.mark.parametrize("n_max", [None, 8])
@pytest.mark.parametrize("need_t", [False, True])
@pytest.mark.parametrize("m,k,n", [(70, 208, 272), (70, 200, 132)],
                         ids=["tc_shape", "dp4a_shape"])
def test_tim_every_path_full_int8_range(dev, mode, packed, n_max, need_t,
                                        m, k, n):
    """F3: x over the whole int8 range, -128 in every row: each TiM
    path (wgmma, tc and dp4a) equals the plain version, which takes |x|
    and max(-x, 0) in int8 as the Pallas kernels do."""
    gen = torch.Generator(device=dev).manual_seed(k + n + len(mode))
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    x[:, ::7] = -128
    wd = _w_operand(gen, dev, k, n, packed)
    w1 = torch.rand(n, generator=gen, device=dev)
    w2 = torch.rand(n, generator=gen, device=dev)
    isc = torch.rand(2 if mode == "phases" else 1, generator=gen,
                     device=dev)
    path = _tim_check(mode, x, wd, w1, w2, isc, packed=packed,
                      need_t=need_t, n_max=n_max, bits=4)
    fits = n_max is None and k % 16 == 0 and n % 16 == 0
    wg = mode == "single" and packed and not need_t
    assert path == ("dp4a" if not fits else "wgmma" if wg else "tc")


# rows 3 and 4 on the tc kernel at its tile edges (128 rows, 128 K codes
# a stage, column tiles of 64 (two-phase) or 128 (bit-serial)): (M, K,
# N, K slices of the two-phase grid, of the bit-serial grid)
TC34_CASES = [
    (1, 1040, 400, 9, 9),       # one row; N and K not multiples of 128
    (70, 208, 272, 2, 2),
    (300, 528, 4224, 1, 1),     # M > 128: three row tiles, fused
    (128, 1040, 8448, 1, 1),
    (128, 4096, 256, 32, 32),   # the served shapes
    (128, 4096, 4096, 2, 4),
    (128, 4096, 13696, 1, 1),
    (128, 13696, 4096, 2, 4),
]


@pytest.mark.parametrize("mode", ["phases", "bits"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("need_t", [True, False])
@pytest.mark.parametrize("m,k,n,splits_phases,splits_bits", TC34_CASES)
def test_tim_tc_rows_3_4_equal_plain(dev, m, k, n, splits_phases,
                                     splits_bits, need_t, packed, mode):
    assert tk.tim_path(mode, packed, None, m, n, k, need_t=need_t) == "tc"
    assert tk.tim_tc_splits(m, n, k, tk.sm_count(dev), tk.TC_TILE_N[mode]) \
        == (splits_phases if mode == "phases" else splits_bits)
    gen = torch.Generator(device=dev).manual_seed(m + k + n + packed)
    # two-phase: x over the whole int8 range; bit-serial: int-k codes
    bits = 2 + (m + k + n) % 6
    lo, hi = (-128, 128) if mode == "phases" else (0, 1 << bits)
    x = torch.randint(lo, hi, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    wd = _w_operand(gen, dev, k, n, packed)
    w1 = torch.rand(n, generator=gen, device=dev)
    w2 = torch.rand(n, generator=gen, device=dev)
    isc = torch.rand(2 if mode == "phases" else 1, generator=gen,
                     device=dev)
    _tim_check(mode, x, wd, w1, w2, isc, packed=packed, need_t=need_t,
               bits=bits)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("m,k,n", [(70, 208, 272), (128, 4096, 4096)])
def test_tim_tc_bitserial_every_width(dev, bits, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(bits)
    x = torch.randint(0, 1 << bits, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    x[:, 0] = (1 << bits) - 1                    # the widest code
    wd = _w_operand(gen, dev, k, n, True)
    w1 = torch.rand(n, generator=gen, device=dev)
    w2 = torch.rand(n, generator=gen, device=dev)
    step = torch.rand(1, generator=gen, device=dev)
    for need_t in (False, True):
        assert _tim_check("bits", x, wd, w1, w2, step, packed=True,
                          need_t=need_t, bits=bits) == "tc"


# row 2 on the swap-AB wgmma kernel: token counts at and around its
# token tiles (8 .. 128, 128-row tiles above), column counts below,
# inside and at the served widths (128 a block), K from one 16-code
# step to the served depths
WG_M = [1, 7, 8, 63, 64, 65, 127, 128, 129, 256]
WG_N = [16, 48, 256, 4096, 13696]
WG_K = [16, 48, 4096, 13696]


def _wg_inputs(dev, m, k, n, seed):
    """x over the whole int8 range (-128 in every row), random packed
    bytes (every 2-bit field, the reserved 0b10 included), random
    scales."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    x[:, ::7] = -128
    wd = _w_operand(gen, dev, k, n, True)
    w1 = torch.rand(n, generator=gen, device=dev)
    w2 = torch.rand(n, generator=gen, device=dev)
    i1 = torch.rand(1, generator=gen, device=dev)
    return x, wd, w1, w2, i1


@pytest.mark.parametrize("k", WG_K)
@pytest.mark.parametrize("n", WG_N)
@pytest.mark.parametrize("m", WG_M)
def test_tim_wg_kernel_equals_plain(dev, m, n, k):
    assert tk.tim_path("single", True, None, m, n, k, need_t=False) == \
        "wgmma"
    x, wd, w1, w2, i1 = _wg_inputs(dev, m, k, n, m + n + k)
    assert _tim_check("single", x, wd, w1, w2, i1, packed=True,
                      need_t=False) == "wgmma"


@pytest.mark.parametrize("m,k,n,splits", [
    (128, 4096, 13696, 1),      # the served shapes at M = 128
    (128, 13696, 4096, 4),
    (128, 4096, 4096, 4),
    (128, 4096, 256, 8),
    (8, 4096, 13696, 1),        # the packed buckets
    (32, 4096, 256, 8),
    (300, 4096, 4096, 1),       # 3 row tiles
    (128, 1040, 256, 2),        # a ragged last slice
])
def test_tim_wg_split_and_unsplit_grids(dev, m, k, n, splits):
    """The K-split grid (int32 atomics, then the epilogue pass) and the
    fused one equal the plain version, and the mma.sync instance on the
    same inputs."""
    assert tk.tim_wg_splits(m, n, k, tk.sm_count(dev)) == splits
    x, wd, w1, w2, i1 = _wg_inputs(dev, m, k, n, splits)
    _tim_check("single", x, wd, w1, w2, i1, packed=True, need_t=False)
    kw = dict(mode="single", packed=True, need_t=False,
              out_dtype=torch.bfloat16)
    wg = tk.tim_st_launch(x, wd, w1, w2, i1, **kw)
    tc = tk.tim_st_launch(x, wd, w1, w2, i1, path="tc", **kw)
    torch.cuda.synchronize()
    assert torch.equal(wg, tc)


def test_tim_wg_wrapper_counts_and_refuses(dev):
    x, wd, w1, w2, i1 = _wg_inputs(dev, 8, 64, 32, 1)
    reset_launch_counts()
    tk.tim_matmul_single(x, wd, w1, w2, i1, packed=True, need_t=False)
    tk.tim_matmul_single(x, wd, w1, w2, i1, packed=True, need_t=True)
    tk.tim_matmul_single(x, wd, w1, w2, i1, packed=True, need_t=False,
                         n_max=8)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["tim_single_packed"] == 3
    assert counts["tim_single_packed_wgmma"] == 1
    assert counts["tim_single_packed_tc"] == 1
    kw = dict(mode="single", packed=True, need_t=False)
    with pytest.raises(ValueError):             # not a wgmma call: T
        tk.tim_st_launch(x, wd, w1, w2, i1, path="wgmma",
                         **dict(kw, need_t=True))
    with pytest.raises(ValueError):             # nor the clamp
        tk.tim_st_launch(x, wd, w1, w2, i1, path="wgmma", n_max=8, **kw)
    with pytest.raises(ValueError):             # dense weights
        tk.tim_st_launch(x, wd.view(torch.int8), w1, w2, i1, **kw)
    with pytest.raises(ValueError):             # a CPU scale
        tk.tim_st_launch(x, wd, w1.cpu(), w2, i1, **kw)
    xm = torch.zeros(8 * 64 + 1, dtype=torch.int8, device=dev)[1:]
    with pytest.raises(ValueError):             # rows not 16-byte aligned
        tk.tim_st_launch(xm.view(8, 64), wd, w1, w2, i1, **kw)
    with pytest.raises(ValueError):             # packed K, not a 4-multiple
        tk.tim_st_launch(x[:, :62].contiguous(), wd, w1, w2, i1, **kw)
    reset_launch_counts()


KV_MODES = ["bf16", "int8", "f32"]
BLOCK_SIZES = [16, 64]


def _attn_inputs(dev, quant, bs=16, f32=False):
    """3 slots over 1024-position tables (several split-KV ranges at
    either block size): a long cache, one with unassigned entries, one
    fully masked."""
    rng = np.random.default_rng(3)
    b, sq, h, hk, d = 3, 4, 8, 2, 128
    nblk = 1024 // bs
    nb = 4 * nblk + 2                  # room for _packed_inputs' 4 slots
    dt = torch.float32 if f32 else torch.bfloat16
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev, dt)
    q, k, v = f(b, sq, h, d), f(nb, bs, hk, d), f(nb, bs, hk, d)
    tbl = rng.permutation(nb)[:b * nblk].reshape(b, nblk).astype(np.int32)
    tbl[1, -(-333 // bs):] = -1
    vlen = np.array([700, 333, 0], np.int32)     # slot 2: fully masked
    qoff = vlen - np.array([4, 1, 0], np.int32)
    kw = {}
    if quant:
        k, ks = _kv_quantize(k)
        v, vs = _kv_quantize(v)
        kw = dict(k_scale=ks, v_scale=vs)
    return (q, k, v, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(vlen).to(dev), torch.from_numpy(qoff).to(dev),
            kw)


def _close(out, ref):
    """bf16: |diff| <= 2^-7 |ref| + 2e-3; f32: f32 rounding (2e-5)."""
    o, r = out.float().cpu(), ref.float().cpu()
    assert torch.isfinite(o).all()
    if out.dtype == torch.float32:
        torch.testing.assert_close(o, r, rtol=2e-5, atol=2e-5)
    else:
        assert ((o - r).abs() <= r.abs() * 2.0 ** -7 + 2e-3).all()


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_paged_kernel_close_to_plain(dev, quant, causal, bs):
    q, k, v, tbl, vlen, qoff, kw = _attn_inputs(dev, quant, bs)
    reset_launch_counts()
    out = pk.paged_attention(q, k, v, tbl, vlen, q_offset=qoff,
                             chunk_kv=64, causal=causal, **kw)
    assert launch_counts()["paged_attention"] == 1
    ref = pk.paged_attention_plain(q, k, v, tbl, vlen, q_offset=qoff,
                                   chunk_kv=64, causal=causal, **kw)
    torch.cuda.synchronize()
    _close(out, ref)
    assert not out[2].any()


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_paged_kernel_f32_close_to_plain(dev, quant, causal, bs):
    """f32 queries (the FMA walk): f32 pools, or int8 codes dequantized
    in f32."""
    q, k, v, tbl, vlen, qoff, kw = _attn_inputs(dev, quant, bs, f32=True)
    out = pk.paged_attention(q, k, v, tbl, vlen, q_offset=qoff,
                             chunk_kv=64, causal=causal, **kw)
    ref = pk.paged_attention_plain(q, k, v, tbl, vlen, q_offset=qoff,
                                   chunk_kv=64, causal=causal, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    _close(out, ref)
    assert not out[2].any()


def test_paged_kernel_f32_queries_over_bf16_pool(dev):
    """An f32 compute config serves over the engine's bf16 cache."""
    q, k, v, tbl, vlen, qoff, _ = _attn_inputs(dev, False, 64)
    q = q.float()
    out = pk.paged_attention(q, k, v, tbl, vlen, q_offset=qoff)
    ref = pk.paged_attention_plain(q, k, v, tbl, vlen, q_offset=qoff,
                                   chunk_kv=64)
    torch.cuda.synchronize()
    _close(out, ref)
    with pytest.raises(ValueError):            # bf16 queries, f32 pools
        pk.paged_attention_launch(q.bfloat16(), k.float(), v.float(), tbl,
                                  vlen, q_offset=qoff)


def _packed_inputs(dev, quant, bs=16, f32=False):
    """A mixed step of 4 slots (prefill across a split-KV range boundary,
    a fresh prompt, a decode, an idle slot) as the padded grid and as its
    flattened tokens plus 3 padding tokens."""
    q, k, v, _, _, _, kw = _attn_inputs(dev, quant, bs, f32)
    rng = np.random.default_rng(7)
    offs, n_new = [254, 0, 700, 0], [4, 5, 1, 0]
    slots, chunk, h, d = 4, 5, q.shape[2], q.shape[3]
    nb, nblk = k.shape[0], 1024 // bs
    tbl = rng.permutation(nb)[:slots * nblk].reshape(slots, nblk).astype(
        np.int32)
    tbl[1, 1:] = -1
    qpad = torch.from_numpy(rng.standard_normal((slots, chunk, h, d)).astype(
        np.float32)).to(dev, q.dtype)
    seg, vlen, qoff, where = [], [], [], []
    for i, (o, n) in enumerate(zip(offs, n_new)):
        for j in range(n):
            seg.append(i)
            vlen.append(o + j + 1)
            qoff.append(o + j)
            where.append((i, j))
    for _ in range(3):
        seg.append(-1)
        vlen.append(0)
        qoff.append(0)
        where.append(None)
    qflat = torch.stack([qpad[w] if w is not None else torch.zeros_like(
        qpad[0, 0]) for w in where])[:, None].contiguous()
    i32 = dict(dtype=torch.int32, device=dev)
    padded = (qpad, k, v, torch.from_numpy(tbl).to(dev),
              torch.tensor(offs, **i32) + torch.tensor(n_new, **i32),
              torch.tensor(offs, **i32))
    flat = (qflat, torch.tensor(seg, **i32), torch.tensor(vlen, **i32),
            torch.tensor(qoff, **i32))
    return padded, flat, where, kw


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("mode", KV_MODES)
def test_packed_kernel_close_to_plain_and_equal_to_mixed(dev, mode, bs):
    (qpad, k, v, tbl, vlen_s, qoff_s), (qf, seg, vlen, qoff), where, kw = \
        _packed_inputs(dev, mode == "int8", bs, mode == "f32")
    reset_launch_counts()
    out = pk.paged_packed_attention(qf, k, v, tbl, seg, vlen, q_offset=qoff,
                                    chunk_kv=64, **kw)
    assert launch_counts()["paged_packed_attention"] == 1
    ref = pk.paged_packed_attention_plain(qf, k, v, tbl, seg, vlen,
                                          q_offset=qoff, chunk_kv=64, **kw)
    mixed = pk.paged_attention_launch(qpad, k, v, tbl, vlen_s,
                                      q_offset=qoff_s, **kw)
    torch.cuda.synchronize()
    _close(out, ref)
    for t, w in enumerate(where):
        if w is None:
            assert not out[t].any()
        else:
            assert torch.equal(out[t, 0], mixed[w]), (t, w)


@pytest.mark.parametrize("d", [8, 72])
def test_paged_kernel_bf16_small_head_fma_walk(dev, d):
    """bf16 queries at a head size the tensor-core walk does not take
    (D % 16 != 0) run the FMA walk: close to plain, and a packed token
    equals its padded row bit for bit."""
    rng = np.random.default_rng(d)
    b, sq, h, hk, bs, nblk = 2, 3, 4, 2, 64, 8
    nb = b * nblk + 1
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev, torch.bfloat16)
    q, k, v = f(b, sq, h, d), f(nb, bs, hk, d), f(nb, bs, hk, d)
    tbl = torch.from_numpy(rng.permutation(nb)[:b * nblk].reshape(
        b, nblk).astype(np.int32)).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    vlen = torch.tensor([500, 64], **i32)
    qoff = vlen - sq
    out = pk.paged_attention_launch(q, k, v, tbl, vlen, q_offset=qoff)
    ref = pk.paged_attention_plain(q, k, v, tbl, vlen, q_offset=qoff,
                                   chunk_kv=64)
    seg = torch.tensor([0, 0, 0, 1, 1, 1], **i32)
    pos = qoff[seg.long()] + torch.tensor([0, 1, 2, 0, 1, 2], **i32)
    packed = pk.paged_packed_attention_launch(
        q.reshape(b * sq, 1, h, d), k, v, tbl, seg, pos + 1, q_offset=pos)
    torch.cuda.synchronize()
    _close(out, ref)
    assert torch.equal(packed[:, 0], out.reshape(b * sq, h, d))


def test_packed_wrapper_counts_and_rejects_bad_input(dev):
    (_, k, v, tbl, _, _), (qf, seg, vlen, qoff), _, _ = \
        _packed_inputs(dev, False)
    reset_launch_counts()
    pk.paged_packed_attention(qf, k, v, tbl, seg, vlen, q_offset=qoff)
    assert launch_counts()["paged_packed_attention"] == 1
    assert launch_counts()["paged_attention"] == 0
    with pytest.raises(ValueError):            # Sq must be 1
        pk.paged_packed_attention_launch(qf.expand(-1, 2, -1, -1)
                                         .contiguous(), k, v, tbl, seg,
                                         vlen, q_offset=qoff)
    with pytest.raises(ValueError):            # per-token length mismatch
        pk.paged_packed_attention_launch(qf, k, v, tbl, seg[:-1], vlen,
                                         q_offset=qoff)
    with pytest.raises(ValueError):            # int8 pool without scales
        pk.paged_packed_attention_launch(qf, k.to(torch.int8), v, tbl, seg,
                                         vlen, q_offset=qoff)
    assert launch_counts()["paged_packed_attention"] == 1


def _shard_inputs(dev, bs=16, f32=False):
    """A mixed step of 3 slots over a pool cut into 4 shards: a long
    cache, one with unassigned entries, one with nothing valid."""
    rng = np.random.default_rng(11)
    b, sq, h, hk, d = 3, 4, 8, 2, 128
    nblk = 1024 // bs
    nb = 4 * (-(-b * nblk // 4) + 1)
    dt = torch.float32 if f32 else torch.bfloat16
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev, dt)
    tbl = rng.permutation(nb)[:b * nblk].reshape(b, nblk).astype(np.int32)
    tbl[1, -(-500 // bs):] = -1
    vlen = np.array([700, 500, 0], np.int32)
    i32 = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (f(b, sq, h, d), f(nb, bs, hk, d), f(nb, bs, hk, d), i32(tbl),
            i32(vlen), i32(np.maximum(vlen - sq, 0)))


def _partials_close(got, want):
    (o, m, l), (ro, rm, rl) = [[t.float().cpu() for t in x]
                               for x in (got, want)]
    assert torch.isfinite(o).all() and torch.isfinite(l).all()
    assert ((m - rm).abs() <= rm.abs() * 1e-5 + 1e-5).all()
    assert ((l - rl).abs() <= rl * 1e-4).all()
    assert ((o - ro).abs() <= rl[..., None] * 1e-4).all()


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("causal", [True, False])
def test_partials_kernel_close_to_plain(dev, causal, bs, f32):
    q, k, v, tbl, vlen, qoff = _shard_inputs(dev, bs, f32)
    n, nb_loc = 4, k.shape[0] // 4
    reset_launch_counts()
    for shard in range(n):
        keep, sel, gid = da._compact(tbl.long(), shard * nb_loc, nb_loc,
                                     min(tbl.shape[1], nb_loc))
        ks, vs = k[shard * nb_loc:(shard + 1) * nb_loc], \
            v[shard * nb_loc:(shard + 1) * nb_loc]
        kw = dict(q_offset=qoff if causal else None, causal=causal,
                  logical_blocks=keep, entry_valid=sel)
        got = pk.paged_attention_partials(q, ks, vs, gid, vlen, **kw)
        want = pk.paged_attention_partials_plain(q, ks, vs, gid, vlen, **kw)
        torch.cuda.synchronize()
        _partials_close(got, want)
        assert (got[1][2] == np.float32(-1e30)).all() and not got[2][2].any()
    assert launch_counts()["paged_attention_partials"] == n


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("causal", [True, False])
def test_stacked_shard_merge_close_to_unsharded_kernel(dev, causal, bs):
    q, k, v, tbl, vlen, qoff = _shard_inputs(dev, bs)
    n, nb_loc = 4, k.shape[0] // 4
    qo = qoff if causal else None
    parts = [da.paged_shard_partial(
        q, k[r * nb_loc:(r + 1) * nb_loc], v[r * nb_loc:(r + 1) * nb_loc],
        tbl, vlen, r, qo) for r in range(n)]
    m, l, o = (torch.stack(x) for x in zip(*parts))
    got = da._lse_merge(m, l, o, q.dtype, da.stacked_reduce)
    want = pk.paged_attention_launch(q, k, v, tbl, vlen, q_offset=qoff,
                                     causal=causal)
    torch.cuda.synchronize()
    g, r = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all() and not g[2].any()
    assert ((g - r).abs() <= r.abs() * 2.0 ** -7 + 2e-3).all()


def test_identity_table_partials_normalize_close_to_paged_kernel(dev):
    q, k, v, tbl, vlen, qoff = _shard_inputs(dev)
    b, nblk = tbl.shape
    ident = torch.arange(nblk, device=dev).expand(b, nblk)
    o, m, l = pk.paged_attention_partials_launch(
        q, k, v, tbl, vlen, q_offset=qoff, causal=True,
        logical_blocks=ident, entry_valid=torch.ones_like(ident))
    want = pk.paged_attention_launch(q, k, v, tbl, vlen, q_offset=qoff)
    got = (o / l.clamp(min=1e-30)[..., None]).movedim(3, 1).reshape(
        want.shape).to(want.dtype)
    torch.cuda.synchronize()
    g, r = got.float().cpu(), want.float().cpu()
    assert ((g - r).abs() <= r.abs() * 2.0 ** -7 + 2e-3).all()


def test_partials_wrapper_rejects_bad_input(dev):
    q, k, v, tbl, vlen, qoff = _shard_inputs(dev)
    keep = torch.arange(tbl.shape[1], device=dev).expand_as(tbl)
    kw = dict(q_offset=qoff, causal=True, logical_blocks=keep,
              entry_valid=torch.ones_like(keep))
    reset_launch_counts()
    with pytest.raises(ValueError):            # int8 pools: no partials
        pk.paged_attention_partials(q, k.to(torch.int8), v.to(torch.int8),
                                    tbl, vlen, **kw)
    with pytest.raises(ValueError):            # logical_blocks shape
        pk.paged_attention_partials_launch(
            q, k, v, tbl, vlen, q_offset=qoff, causal=True,
            logical_blocks=keep[:, :-1], entry_valid=keep[:, :-1])
    assert launch_counts()["paged_attention_partials"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,sk,h,hk,d,causal", [
    (2, 40, 40, 8, 2, 128, True),
    (1, 33, 33, 4, 4, 32, True),
    (1, 17, 70, 4, 1, 64, False),     # both dims ragged against the tiles
    (2, 24, 48, 8, 4, 16, False),
    (1, 150, 150, 4, 2, 128, True),   # 3 query and key tiles, ragged
    (1, 70, 200, 8, 2, 128, False),   # Sk not a multiple of 64
    (1, 9, 130, 4, 4, 80, False),     # D padded to 128
])
def test_flash_kernel_close_to_plain(dev, dtype, b, sq, sk, h, hk, d,
                                     causal):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype) for s in ((b, sq, h, d), (b, sk, hk, d),
                                         (b, sk, hk, d)))
    reset_launch_counts()
    out = fk.flash_attention(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 1
    ref = fk.flash_attention_plain(q, k, v, causal=causal, chunk_kv=16)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    o, r = out.float().cpu(), ref.float().cpu()
    if dtype == torch.bfloat16:
        assert ((o - r).abs() <= r.abs() * 2.0 ** -7 + 2e-3).all()
    else:
        torch.testing.assert_close(o, r, rtol=2e-5, atol=2e-5)


def test_flash_wrapper_rejects_bad_input(dev):
    q = torch.zeros((1, 8, 4, 16), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 16), device=dev, dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(ValueError):            # mixed dtypes
        fk.flash_attention(q, k.float(), k.float())
    with pytest.raises(ValueError):            # H % Hk != 0
        fk.flash_attention_launch(q, k[:, :, :1].expand(1, 8, 3, 16)
                                  .contiguous(), k[:, :, :1]
                                  .expand(1, 8, 3, 16).contiguous())
    with pytest.raises(ValueError):            # D % 4 != 0
        fk.flash_attention_launch(q[..., :6].contiguous(),
                                  k[..., :6].contiguous(),
                                  k[..., :6].contiguous())
    assert launch_counts()["flash_attention"] == 1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,sq,sk,h,hk,causal", [
    (1, 128, 128, 2, 2, True),        # one query block, one key tile
    (2, 200, 200, 4, 2, True),        # ragged against 128 rows and keys
    (1, 300, 300, 4, 1, True),        # 3 blocks; a K/V ring reused
    (1, 256, 384, 4, 2, True),        # Sk > Sq, top-left causal
    (1, 70, 300, 8, 2, False),        # one ragged query block
    (2, 333, 77, 4, 4, False),        # Sk < one key tile
    (1, 129, 600, 2, 1, False),       # 5 key tiles, ragged
])
def test_flash_wgmma_close_to_plain(dev, d, b, sq, sk, h, hk, causal):
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, torch.bfloat16)
               for s in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d)))
    assert fk.flash_path(torch.bfloat16, d) == "wgmma"
    reset_launch_counts()
    out = fk.flash_attention(q, k, v, causal=causal)
    counts = launch_counts()
    assert counts["flash_attention"] == counts["flash_wgmma"] == 1
    assert counts["flash_mma"] == counts["flash_fma"] == 0
    ref = fk.flash_attention_plain(q, k, v, causal=causal, chunk_kv=64)
    torch.cuda.synchronize()
    o, r = out.float().cpu(), ref.float().cpu()
    assert ((o - r).abs() <= r.abs() * 2.0 ** -7 + 2e-3).all()


@pytest.mark.parametrize("dtype,d,path", [
    (torch.bfloat16, 32, "mma"), (torch.bfloat16, 80, "mma"),
    (torch.bfloat16, 72, "fma"), (torch.float32, 64, "fma")])
def test_flash_other_paths_counted(dev, dtype, d, path):
    q = torch.randn((1, 40, 4, d), device=dev).to(dtype)
    k = torch.randn((1, 40, 2, d), device=dev).to(dtype)
    reset_launch_counts()
    fk.flash_attention(q, k, k, causal=True)
    counts = launch_counts()
    assert counts["flash_attention"] == counts[f"flash_{path}"] == 1


# -- the GQA groups of yi-34b (G = 7) and llama3-405b (G = 16) -------------

@pytest.mark.parametrize("g", [7, 16])
@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernel_wide_groups_close_to_plain(dev, g, bs, quant):
    """Query groups of 7 and 16 heads per KV head at D = 128 (the served
    widths of yi-34b and llama3-405b), mixed and packed: close to plain,
    and the packed kernel equal to the mixed kernel token by token."""
    rng = np.random.default_rng(g + bs)
    b, sq, hk, d, nblk = 3, 4, 2, 128, 1024 // bs
    h = g * hk
    nb = b * nblk + 1
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev, torch.bfloat16)
    q, k, v = f(b, sq, h, d), f(nb, bs, hk, d), f(nb, bs, hk, d)
    kw = {}
    if quant:
        k, ks = _kv_quantize(k)
        v, vs = _kv_quantize(v)
        kw = dict(k_scale=ks, v_scale=vs)
    tbl = torch.from_numpy(rng.permutation(nb)[:b * nblk].reshape(
        b, nblk).astype(np.int32)).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    vlen = torch.tensor([700, 333, 5], **i32)
    qoff = vlen - torch.tensor([4, 1, 4], **i32)
    out = pk.paged_attention(q, k, v, tbl, vlen, q_offset=qoff,
                             chunk_kv=64, **kw)
    ref = pk.paged_attention_plain(q, k, v, tbl, vlen, q_offset=qoff,
                                   chunk_kv=64, **kw)
    seg = torch.arange(b, **i32).repeat_interleave(sq)
    pos = qoff[seg.long()] + torch.arange(sq, **i32).repeat(b)
    packed = pk.paged_packed_attention(
        q.reshape(b * sq, 1, h, d), k, v, tbl, seg, pos + 1, q_offset=pos,
        chunk_kv=64, **kw)
    torch.cuda.synchronize()
    _close(out, ref)
    rows = out.reshape(b * sq, h, d)
    valid = (pos < vlen[seg.long()]).cpu()
    for t in range(b * sq):
        if valid[t]:
            assert torch.equal(packed[t, 0], rows[t]), t


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_paged_kernel_row_does_not_depend_on_later_rows(dev, bs):
    """The lossless contract of greedy speculation: a query row's output
    is the same bits whether its slot also carries later rows (a verify
    step's k + 1 tokens) or the row is decoded alone at its position."""
    rng = np.random.default_rng(bs)
    b, h, hk, d, nblk, k = 2, 32, 2, 128, 2048 // bs, 3
    nb = b * nblk + 1
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev, torch.bfloat16)
    q, kp, vp = f(b, 16, h, d), f(nb, bs, hk, d), f(nb, bs, hk, d)
    tbl = torch.from_numpy(rng.permutation(nb)[:b * nblk].reshape(
        b, nblk).astype(np.int32)).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    cl = torch.tensor([300, 1023], **i32)
    verify = pk.paged_attention(q, kp, vp, tbl, cl + k + 1, q_offset=cl,
                                chunk_kv=64)
    for j in range(k + 1):
        qj = torch.zeros_like(q)
        qj[:, 0] = q[:, j]
        alone = pk.paged_attention(qj, kp, vp, tbl, cl + j + 1,
                                   q_offset=cl + j, chunk_kv=64)
        torch.cuda.synchronize()
        assert torch.equal(alone[:, 0], verify[:, j]), j


# -- the int2 draft of speculative decoding (row 4 at bits = 2) -----------

@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 256), (4096, 13696),
                                 (13696, 4096)])
def test_tim_bitserial_int2_draft_shape(dev, k, n):
    """The draft pass of a policy-A target: M = 8 slots, 2-bit codes,
    packed weights, on the tc kernel, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(k + n)
    x = torch.randint(0, 4, (8, k), generator=gen, device=dev,
                      dtype=torch.int8)
    wd = _w_operand(gen, dev, k, n, True)
    w1 = torch.rand(n, generator=gen, device=dev)
    w2 = torch.rand(n, generator=gen, device=dev)
    step = torch.tensor([1.0 / 3], device=dev).bfloat16().float()
    assert _tim_check("bits", x, wd, w1, w2, step, packed=True,
                      need_t=False, bits=2) == "tc"


# -- the sampler on the card -------------------------------------------------

def test_prng_on_cuda_equals_cpu(dev):
    from repro_torch.core import prng
    keys = prng.fold_in(prng.prng_key(7), torch.arange(8))
    for shape in ((), (5,), (65024,)):
        a = prng.random_bits(keys, shape)
        c = prng.random_bits(keys.to(dev), shape).cpu()
        assert torch.equal(a, c)
        assert torch.equal(prng.uniform(keys, shape),
                           prng.uniform(keys.to(dev), shape).cpu())
    g = prng.gumbel(keys, (65024,))
    gc = prng.gumbel(keys.to(dev), (65024,)).cpu()
    ulp = torch.from_numpy(np.spacing(np.maximum(g.abs().numpy(), 1.0)
                                      .astype(np.float32)))
    assert ((gc - g).abs() <= 4 * ulp).all()
    assert torch.equal(prng.fold_in(keys.to(dev), 3).cpu(),
                       prng.fold_in(keys, 3))


def test_sampler_on_cuda_equals_cpu(dev):
    """The same f32 logits sample the same tokens (where the perturbed
    top two differ by more than 1e-5) and the same top-k candidates on
    the card as on the CPU; so do the speculative accept function's
    emissions."""
    from repro_torch.core import prng
    from repro_torch.serve import engine as teng
    rng = np.random.default_rng(0)
    slots, vocab = 8, 65024
    lg = torch.from_numpy((rng.standard_normal((slots, vocab)) * 3).astype(
        np.float32))
    ids = np.stack([np.arange(slots) + 100, np.arange(slots) % 3,
                    np.arange(slots) * 5], 1)
    mask = torch.full((slots, 8), -1, dtype=torch.int32)
    mask[3, :4] = torch.tensor([5, 17, 900, 64000])
    base = prng.prng_key(3)
    for temperature in (1.0, 0.7):
        fn = teng.make_sample_fn(temperature, 4)
        t_cpu, i_cpu, l_cpu = fn(lg, base, ids, mask)
        t_gpu, i_gpu, l_gpu = fn(lg.to(dev), base, ids, mask.to(dev))
        keys = teng.derive_sample_key(base, *torch.from_numpy(ids).T)
        scores = prng.gumbel(keys, (vocab,)) + \
            teng.apply_token_masks(lg, mask) / temperature
        top = scores.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 1e-5
        assert torch.equal(t_cpu[clear], t_gpu.cpu()[clear])
        assert torch.equal(i_cpu, i_gpu.cpu())
        torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-6, atol=1e-6)
    chunk = 4
    lg3 = lg[:, None].repeat(1, chunk, 1).contiguous()
    toks = torch.from_numpy(rng.integers(0, vocab, (slots, chunk)).astype(
        np.int32))
    toks[:, 1] = lg.argmax(-1).int()
    start = torch.zeros(slots, dtype=torch.int64)
    n_draft = torch.full((slots,), chunk - 1, dtype=torch.int64)
    masks = torch.full((slots, chunk, 8), -1, dtype=torch.int32)
    for temperature in (0.0, 1.0):
        fn = teng.make_spec_accept_fn(temperature)
        e_cpu, n_cpu = fn(lg3, toks, start, n_draft, base, ids, masks)
        e_gpu, n_gpu = fn(lg3.to(dev), toks, start, n_draft, base, ids,
                          masks)
        assert torch.equal(n_cpu, n_gpu.cpu())
        for i in range(slots):
            assert torch.equal(e_cpu[i, :n_cpu[i]],
                               e_gpu.cpu()[i, :n_cpu[i]])

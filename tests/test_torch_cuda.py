"""The Hopper kernels against their plain PyTorch versions (CUDA card).

Imports only torch, numpy and the port, so it also runs on a machine
without JAX: ``python -m pytest -q -m cuda --noconftest
tests/test_torch_cuda.py``.  Without a card every test skips.

Tolerances: the TiM kernels equal their plain versions bit for bit
(exact int32 products, the same correctly rounded f32 epilogue); paged
attention, mixed and packed, agrees to about one bf16 ulp (per-KV-block
online softmax and another summation order): |diff| <= 2^-7 * |ref| +
2e-3.  The packed kernel equals the mixed kernel bit for bit, token by
token (the same compiled kernel, Sq = 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.packing import pack2b  # noqa: E402
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


def _attn_inputs(dev, quant):
    rng = np.random.default_rng(3)
    b, sq, h, hk, d, bs, nblk, nb = 3, 4, 8, 2, 128, 16, 6, 20
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(
        np.float32)).bfloat16().to(dev)
    k = torch.from_numpy(rng.standard_normal((nb, bs, hk, d)).astype(
        np.float32)).bfloat16().to(dev)
    v = torch.from_numpy(rng.standard_normal((nb, bs, hk, d)).astype(
        np.float32)).bfloat16().to(dev)
    tbl = rng.permutation(nb)[:b * nblk].reshape(b, nblk).astype(np.int32)
    tbl[1, 3:] = -1
    vlen = np.array([70, 33, 0], np.int32)       # slot 2: fully masked
    qoff = vlen - np.array([4, 1, 0], np.int32)
    kw = {}
    if quant:
        k, ks = _kv_quantize(k)
        v, vs = _kv_quantize(v)
        kw = dict(k_scale=ks, v_scale=vs)
    return (q, k, v, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(vlen).to(dev), torch.from_numpy(qoff).to(dev),
            kw)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_paged_kernel_close_to_plain(dev, quant, causal):
    q, k, v, tbl, vlen, qoff, kw = _attn_inputs(dev, quant)
    reset_launch_counts()
    out = pk.paged_attention(q, k, v, tbl, vlen, q_offset=qoff,
                             chunk_kv=32, causal=causal, **kw)
    assert launch_counts()["paged_attention"] == 1
    ref = pk.paged_attention_plain(q, k, v, tbl, vlen, q_offset=qoff,
                                   chunk_kv=32, causal=causal, **kw)
    torch.cuda.synchronize()
    o, r = out.float().cpu(), ref.float().cpu()
    assert torch.isfinite(o).all()
    assert ((o - r).abs() <= r.abs() * 2.0 ** -7 + 2e-3).all()
    assert not o[2].any()


def _packed_inputs(dev, quant):
    """A mixed step of 4 slots (prefill past a block boundary, a fresh
    prompt, a decode, an idle slot) as the padded grid and as its
    flattened tokens plus 3 padding tokens."""
    q, k, v, _, _, _, kw = _attn_inputs(dev, quant)
    rng = np.random.default_rng(7)
    offs, n_new = [37, 0, 70, 0], [4, 5, 1, 0]
    slots, chunk, h, d = 4, 5, q.shape[2], q.shape[3]
    nb = k.shape[0]
    tbl = rng.permutation(nb)[:slots * 4].reshape(slots, 4).astype(np.int32)
    tbl[1, 1:] = -1
    qpad = torch.from_numpy(rng.standard_normal((slots, chunk, h, d)).astype(
        np.float32)).bfloat16().to(dev)
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


@pytest.mark.parametrize("quant", [False, True])
def test_packed_kernel_close_to_plain_and_equal_to_mixed(dev, quant):
    (qpad, k, v, tbl, vlen_s, qoff_s), (qf, seg, vlen, qoff), where, kw = \
        _packed_inputs(dev, quant)
    reset_launch_counts()
    out = pk.paged_packed_attention(qf, k, v, tbl, seg, vlen, q_offset=qoff,
                                    chunk_kv=32, **kw)
    assert launch_counts()["paged_packed_attention"] == 1
    ref = pk.paged_packed_attention_plain(qf, k, v, tbl, seg, vlen,
                                          q_offset=qoff, chunk_kv=32, **kw)
    mixed = pk.paged_attention_launch(qpad, k, v, tbl, vlen_s,
                                      q_offset=qoff_s, **kw)
    torch.cuda.synchronize()
    o, r = out.float().cpu(), ref.float().cpu()
    assert torch.isfinite(o).all()
    assert ((o - r).abs() <= r.abs() * 2.0 ** -7 + 2e-3).all()
    for t, w in enumerate(where):
        if w is None:
            assert not out[t].any()
        else:
            assert torch.equal(out[t, 0], mixed[w]), (t, w)


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

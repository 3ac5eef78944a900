"""The port's kernel dispatch rules, held on the CPU.

``tim_path`` / ``tim_tc_splits`` / ``tim_wg_tile`` / ``tim_wg_splits``
(kernels/tim_matmul.py) and ``flash_path`` (kernels/flash_attention.py)
are plain functions of the call's mode, types and shapes: which Hopper
kernel serves a CUDA call, how the s8 mma.sync TiM kernel cuts K (its
two-phase instance has column tiles of 64, the others of 128), and the
wgmma kernel's token tile and K slices.  The kernels themselves run
only on the card (tests/test_torch_cuda.py); here CPU tensors must
still run the plain versions, with no launch counted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.packing import pack2b  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import tim_matmul as tk  # noqa: E402

H100_SMS = 132     # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("mode,packed,n_max,m,n,k,path", [
    # the served shapes of policy B (M = 128 rows of the padded step)
    ("single", False, None, 128, 4096, 4096, "tc"),
    ("single", False, None, 128, 256, 4096, "tc"),
    ("single", False, None, 128, 13696, 4096, "tc"),
    ("single", False, None, 128, 4096, 13696, "tc"),
    ("single", False, None, 1, 400, 1040, "tc"),
    ("single", False, None, 300, 4224, 528, "tc"),
    # two-phase (policy C) and bit-serial (policy A), dense or packed
    ("phases", False, None, 128, 4096, 4096, "tc"),
    ("bits", False, None, 128, 4096, 4096, "tc"),
    ("phases", True, None, 128, 13696, 4096, "tc"),
    ("phases", True, None, 128, 4096, 13696, "tc"),
    ("phases", True, None, 70, 272, 1040, "tc"),
    ("bits", True, None, 128, 256, 4096, "tc"),
    ("bits", True, None, 300, 4224, 528, "tc"),
    ("phases", True, None, 128, 130, 4096, "dp4a"),      # N % 16 != 0
    ("bits", True, None, 128, 256, 200, "dp4a"),         # K % 16 != 0
    # what the tc kernel does not take
    ("single", False, 8, 128, 4096, 4096, "dp4a"),       # the ADC clamp
    ("phases", True, 8, 128, 4096, 4096, "dp4a"),
    ("phases", False, 8, 128, 4096, 4096, "dp4a"),
    ("bits", True, 8, 128, 4096, 4096, "dp4a"),
    ("single", True, None, 128, 4096, 4096, "wgmma"),    # packed weights
    ("single", True, None, 128, 13696, 4096, "wgmma"),
    ("single", False, None, 128, 130, 4096, "dp4a"),     # N % 16 != 0
    ("single", False, None, 128, 256, 200, "dp4a"),      # K % 16 != 0
    ("single", False, None, 4, 8, 8, "dp4a"),            # N, K < 16
])
def test_tim_path_rule(mode, packed, n_max, m, n, k, path):
    assert tk.tim_path(mode, packed, n_max, m, n, k, need_t=False) == path


@pytest.mark.parametrize("m", [1, 8, 128, 300])
@pytest.mark.parametrize("need_t,n_max,n,k,path", [
    (False, None, 13696, 4096, "wgmma"),   # row 2: the swap-AB kernel
    (False, None, 4096, 13696, "wgmma"),
    (False, None, 256, 4096, "wgmma"),
    (False, None, 16, 16, "wgmma"),
    (True, None, 4096, 4096, "tc"),        # with T: the mma.sync kernel
    (True, None, 256, 4096, "tc"),
    (False, 8, 4096, 4096, "dp4a"),        # the ADC clamp
    (True, 8, 4096, 4096, "dp4a"),
    (False, None, 130, 4096, "dp4a"),      # N % 16 != 0
    (False, None, 256, 200, "dp4a"),       # K % 16 != 0
])
def test_tim_path_rule_single_packed(m, need_t, n_max, n, k, path):
    assert tk.tim_path("single", True, n_max, m, n, k,
                       need_t=need_t) == path
    # T changes the path of this product alone
    assert tk.tim_path("single", False, n_max, m, n, k, need_t=need_t) == \
        ("dp4a" if path == "dp4a" else "tc")


@pytest.mark.parametrize("m,tile", [
    (1, 8), (7, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32),
    (33, 64), (64, 64), (65, 128), (128, 128), (129, 128), (300, 128)])
def test_tim_wg_tile_rule(m, tile):
    assert tk.tim_wg_tile(m) == tile
    assert tile in tk.WG_TILES


@pytest.mark.parametrize("m,n,k,splits", [
    (128, 13696, 4096, 1),     # 107 column tiles fill the card: fused
    (8, 13696, 4096, 1),       # the packed buckets: the same grid
    (32, 13696, 4096, 1),
    (128, 8448, 1040, 1),      # 66 tiles: the smallest fused grid
    (128, 8320, 4096, 2),      # 65 tiles: K split
    (128, 4096, 4096, 4),      # 32 tiles x 4 slices of 8 K tiles
    (128, 4096, 13696, 4),     # 4 slices of 27
    (8, 4096, 4096, 4),
    (128, 256, 4096, 8),       # 2 tiles: 8 slices of 4 K tiles
    (1, 256, 4096, 8),
    (128, 256, 1040, 2),       # 9 K tiles: 2 slices of at least 4
    (128, 256, 384, 1),        # 3 K tiles: too short to split
    (300, 4096, 4096, 1),      # 3 row tiles x 32 column tiles
    (256, 4096, 4096, 2),      # 2 row tiles x 32
    (1, 16, 16, 1),
])
def test_tim_wg_splits_rule(m, n, k, splits):
    got = tk.tim_wg_splits(m, n, k, H100_SMS)
    assert got == splits
    tiles = -(-m // tk.tim_wg_tile(m)) * -(-n // tk.WG_COLS)
    assert got == 1 or tiles * got <= H100_SMS            # one wave
    assert got == 1 or -(-k // tk.TC_TILE) >= got * tk.WG_MIN_SLICE


@pytest.mark.parametrize("m,n,k,splits", [
    (128, 13696, 4096, 1),     # 107 column tiles fill the card: fused
    (128, 8448, 1040, 1),      # 66 tiles: the smallest fused grid
    (128, 8320, 1040, 2),      # 65 tiles: K split
    (128, 4096, 4096, 4),      # 32 tiles x 4 slices = 128 blocks
    (128, 4096, 13696, 4),
    (128, 256, 4096, 32),      # 2 tiles: one slice per K tile
    (1, 400, 1040, 9),         # 4 tiles, 9 K tiles
    (300, 4224, 528, 1),       # 3 row tiles x 33 column tiles
    (128, 128, 128, 1),        # a single K tile cannot be split
])
def test_tim_tc_splits_rule(m, n, k, splits):
    got = tk.tim_tc_splits(m, n, k, H100_SMS)
    assert got == splits
    assert got == tk.tim_tc_splits(m, n, k, H100_SMS, tk.TC_TILE_N["bits"])
    tiles = -(-m // tk.TC_TILE) * -(-n // tk.TC_TILE)
    assert got == 1 or tiles * got <= H100_SMS    # one wave


@pytest.mark.parametrize("m,n,k,splits", [
    (128, 13696, 4096, 1),     # 214 column tiles of 64: fused
    (128, 4224, 1040, 1),      # 66 tiles: the smallest fused grid
    (128, 4160, 1040, 2),      # 65 tiles: K split
    (128, 4096, 4096, 2),      # 64 tiles x 2 slices = 128 blocks
    (128, 4096, 13696, 2),
    (128, 256, 4096, 32),      # 4 tiles: one slice per K tile
    (1, 400, 1040, 9),         # 7 tiles, 9 K tiles
    (300, 2112, 528, 1),       # 3 row tiles x 33 column tiles
])
def test_tim_tc_splits_rule_two_phase(m, n, k, splits):
    tile_n = tk.TC_TILE_N["phases"]
    assert tile_n == 64
    got = tk.tim_tc_splits(m, n, k, H100_SMS, tile_n)
    assert got == splits
    tiles = -(-m // tk.TC_TILE) * -(-n // tile_n)
    assert got == 1 or tiles * got <= H100_SMS    # one wave


@pytest.mark.parametrize("dtype,d,path", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.bfloat16, 80, "mma"), (torch.bfloat16, 96, "mma"),
    (torch.bfloat16, 72, "fma"), (torch.bfloat16, 256, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
])
def test_flash_path_rule(dtype, d, path):
    assert fk.flash_path(dtype, d) == path


@pytest.mark.parametrize("need_t", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_tim_single_cpu_runs_plain_and_counts_nothing(need_t, out_dtype):
    rng = np.random.default_rng(5)
    m, k, n = 33, 64, 48          # a tc-eligible shape
    x = torch.from_numpy(rng.integers(-1, 2, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-1, 2, (k, n)).astype(np.int8))
    w1 = torch.from_numpy(rng.random(n).astype(np.float32))
    w2 = torch.from_numpy(rng.random(n).astype(np.float32))
    i1 = torch.tensor(0.25)
    assert tk.tim_path("single", False, None, m, n, k, need_t=need_t) == "tc"
    reset_launch_counts()
    got = tk.tim_matmul_single(x, w, w1, w2, i1, packed=False,
                               need_t=need_t, out_dtype=out_dtype)
    assert not any(launch_counts().values())
    want = tk.tim_st_plain(x, w, w1, w2, i1.reshape(1), mode="single",
                           packed=False, need_t=need_t, out_dtype=out_dtype)
    assert torch.equal(got, want)
    # the plain version's integer products, by hand
    s = x.long() @ w.long()
    t = x.long().abs() @ w.long().abs()
    ref = (w1 + w2) * 0.5 * s.float()
    if need_t:
        ref = ref + (w1 - w2) * 0.5 * t.float()
    assert torch.equal(got, (i1 * ref).to(out_dtype))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("need_t", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_tim_two_phase_cpu_runs_plain_and_counts_nothing(packed, need_t,
                                                         out_dtype):
    rng = np.random.default_rng(6)
    m, k, n = 33, 64, 48          # a tc-eligible shape
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-1, 2, (k, n)).astype(np.int8))
    wd = pack2b(w, axis=0) if packed else w
    w1 = torch.from_numpy(rng.random(n).astype(np.float32))
    w2 = torch.from_numpy(rng.random(n).astype(np.float32))
    i1, i2 = torch.tensor(0.25), torch.tensor(0.5)
    assert tk.tim_path("phases", packed, None, m, n, k,
                       need_t=need_t) == "tc"
    reset_launch_counts()
    got = tk.tim_matmul_fused(x, wd, w1, w2, i1, i2, packed=packed,
                              need_t=need_t, out_dtype=out_dtype)
    assert not any(launch_counts().values())
    # the plain version's phases by hand, each rounded before p1 - p2
    xl, wl = x.long(), w.long()
    pos, neg = xl.clamp(min=0), (-xl).clamp(min=0)
    neg[x == -128] = 0                 # -(-128) wraps in int8

    def phase(a, i):
        ref = (w1 + w2) * 0.5 * (a @ wl).float()
        if need_t:
            ref = ref + (w1 - w2) * 0.5 * (a @ wl.abs()).float()
        return (i * ref).to(out_dtype)
    want = (phase(pos, i1) - phase(neg, i2)).to(out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("need_t", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_tim_single_packed_cpu_runs_plain_and_counts_nothing(m, need_t,
                                                             out_dtype):
    rng = np.random.default_rng(m)
    k, n = 64, 48                 # a wgmma / tc-eligible shape
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    # random packed bytes: every 2-bit field, the reserved 0b10 included
    wp = torch.from_numpy(rng.integers(0, 256, (k // 4, n)).astype(np.uint8))
    w1 = torch.from_numpy(rng.random(n).astype(np.float32))
    w2 = torch.from_numpy(rng.random(n).astype(np.float32))
    i1 = torch.tensor(0.25)
    assert tk.tim_path("single", True, None, m, n, k, need_t=need_t) == \
        ("tc" if need_t else "wgmma")
    reset_launch_counts()
    got = tk.tim_matmul_single(x, wp, w1, w2, i1, packed=True,
                               need_t=need_t, out_dtype=out_dtype)
    assert not any(launch_counts().values())
    # the codes by hand: 00 -> 0, 01 -> 1, 10 -> 0, 11 -> -1
    fields = (wp.long()[:, None, :] >> (2 * torch.arange(4))[None, :, None]
              ) & 3
    w = ((fields == 1).long() - (fields == 3).long()).reshape(k, n)
    s = x.long() @ w
    ref = (w1 + w2) * 0.5 * s.float()
    if need_t:
        # |x| in int8, as the Pallas kernels take it: |-128| wraps
        ref = ref + (w1 - w2) * 0.5 * (x.abs().long() @ w.abs()).float()
    assert torch.equal(got, (i1 * ref).to(out_dtype))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("need_t", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 7])
def test_tim_bitserial_cpu_runs_plain_and_counts_nothing(packed, need_t,
                                                         bits):
    rng = np.random.default_rng(bits)
    m, k, n = 20, 96, 32          # a tc-eligible shape
    x = torch.from_numpy(rng.integers(0, 1 << bits, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-1, 2, (k, n)).astype(np.int8))
    wd = pack2b(w, axis=0) if packed else w
    w1 = torch.from_numpy(rng.random(n).astype(np.float32))
    w2 = torch.from_numpy(rng.random(n).astype(np.float32))
    step = torch.tensor(0.0625)
    assert tk.tim_path("bits", packed, None, m, n, k,
                       need_t=need_t) == "tc"
    reset_launch_counts()
    got = tk.tim_matmul_bitserial(x, wd, w1, w2, step, bits=bits,
                                  packed=packed, need_t=need_t)
    assert not any(launch_counts().values())
    # sum_b (plane_b @ W) << b, by hand: the codes' single product
    s = sum(((x.long() >> b) & 1) @ w.long() << b for b in range(bits))
    t = sum(((x.long() >> b) & 1) @ w.long().abs() << b
            for b in range(bits))
    assert torch.equal(s, x.long() @ w.long())
    ref = (w1 + w2) * 0.5 * s.float()
    if need_t:
        ref = ref + (w1 - w2) * 0.5 * t.float()
    assert torch.equal(got, step * ref)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_cpu_bf16_runs_plain_and_counts_nothing(d):
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, 20, 4, d), (1, 20, 2, d),
                                     (1, 20, 2, d)))
    assert fk.flash_path(q.dtype, d) == "wgmma"
    reset_launch_counts()
    got = fk.flash_attention(q, k, v, causal=True)
    assert not any(launch_counts().values())
    assert torch.equal(got, fk.flash_attention_plain(q, k, v, causal=True))

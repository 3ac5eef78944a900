"""The TiM plain route at the int8 edge x = -128, against the Pallas
kernels it replaces (run in interpret mode, as the reference's own tests
run them off the TPU).

The Pallas kernels take |x| and max(-x, 0) in int8, where both wrap:
|-128| = -128 and -(-128) = -128, so max(-(-128), 0) = 0.  The port's
plain route (and, on the card, every TiM kernel, tests/test_torch_cuda.py)
must compute the same, with and without the ADC clamp ``n_max``.
Scales are dyadic (k/8, input scales 1/4 and 1/8) and the products stay
far below 2^24, so every f32 step is exact and the comparison is bit for
bit, in f32 and in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.tim_matmul import (tim_matmul_fused_pallas,  # noqa: E402
                                      tim_matmul_pallas)

from repro_torch.core.packing import pack2b  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import tim_matmul as tk  # noqa: E402

M, K, N = 8, 64, 32
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    x[rng.random((M, K)) < 0.25] = -128      # the edge, in every row
    x[0, :] = -128                            # and one row of it alone
    w = rng.integers(-1, 2, (K, N)).astype(np.int8)
    w1 = (rng.integers(1, 9, N) / 8).astype(np.float32)
    w2 = (rng.integers(1, 9, N) / 8).astype(np.float32)
    return x, w, w1, w2


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _saturated_t(x, w):
    """T = |x| @ |W| with |-128| taken as +128: what the route must not
    give (so that the test sees the edge)."""
    return np.abs(x.astype(np.int64)) @ np.abs(w.astype(np.int64))


@pytest.mark.parametrize("n_max", [None, 8])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_single_phase_plain_wraps_like_pallas(n_max, dtypes):
    tdt, jdt = dtypes
    x, w, w1, w2 = _inputs(1)
    i1 = np.float32(0.25)
    ref = tim_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(w1),
                            jnp.asarray(w2), jnp.asarray(i1)[None],
                            need_t=True, n_max=n_max, out_dtype=jdt,
                            interpret=True)
    reset_launch_counts()
    ours = tk.tim_matmul_single(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(w1), torch.from_numpy(w2),
                                torch.tensor(i1), packed=False, need_t=True,
                                n_max=n_max, out_dtype=tdt)
    assert not any(launch_counts().values())      # CPU: the plain version
    np.testing.assert_array_equal(_np(ours), _np(ref))
    if n_max is None:
        # without the clamp: out = i1 * (cs S + ct T), T wrapped at -128
        s = x.astype(np.int64) @ w.astype(np.int64)
        sat = (w1 + w2) * 0.5 * s + (w1 - w2) * 0.5 * _saturated_t(x, w)
        assert not np.array_equal(_np(ours), (i1 * sat).astype(np.float32))


@pytest.mark.parametrize("n_max", [None, 8])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_two_phase_plain_wraps_like_pallas(n_max, packed, dtypes):
    tdt, jdt = dtypes
    x, w, w1, w2 = _inputs(2)
    i1, i2 = np.float32(0.25), np.float32(0.125)
    wt = torch.from_numpy(w)
    wd = pack2b(wt, axis=0) if packed else wt
    ref = tim_matmul_fused_pallas(
        jnp.asarray(x), jnp.asarray(wd.numpy()), jnp.asarray(w1),
        jnp.asarray(w2), jnp.asarray(i1), jnp.asarray(i2), packed=packed,
        need_t=True, n_max=n_max, out_dtype=jdt, interpret=True)
    reset_launch_counts()
    ours = tk.tim_matmul_fused(torch.from_numpy(x), wd,
                               torch.from_numpy(w1), torch.from_numpy(w2),
                               torch.tensor(i1), torch.tensor(i2),
                               packed=packed, need_t=True, n_max=n_max,
                               out_dtype=tdt)
    assert not any(launch_counts().values())
    np.testing.assert_array_equal(_np(ours), _np(ref))
    # -128 has no negative phase (max(-(-128), 0) wraps to 0): the
    # all -128 row is the positive phase's, which is 0 too
    np.testing.assert_array_equal(_np(ours)[0], np.zeros(N, np.float32))


@pytest.mark.parametrize("mode", ["single", "phases"])
def test_clamped_route_takes_abs_in_int8(mode):
    """The clamp's T of one access at x = -128 alone: |x| wraps, so each
    16-code block gives T = -128 * sum|w| (single-phase); the two-phase
    route has no phase at all there."""
    x = np.full((1, 16), -128, np.int8)
    w = np.ones((16, 4), np.int8)
    one = torch.ones(4)
    iscale = torch.tensor([1.0, 1.0] if mode == "phases" else [1.0])
    got = tk.tim_st_plain(torch.from_numpy(x), torch.from_numpy(w), one,
                          torch.zeros(4), iscale, mode=mode, packed=False,
                          need_t=True, n_max=4096)
    # cs = ct = 0.5: out = 0.5 * (S + T) = n, the clamped count
    want = -2048.0 if mode == "single" else 0.0
    np.testing.assert_array_equal(got.numpy(), np.full((1, 4), want))

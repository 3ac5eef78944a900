"""Row 2 of the kernel table (the single-phase product of 2-bit packed
weights) against the Pallas kernel it replaces.

On the CPU the port's wrapper runs the plain version; here it is held
to ``tim_matmul_packed_pallas`` run in interpret mode (as the
reference's own tests run it off the TPU) at the token counts the
engine serves it: M = 1 and 8 (token-packed buckets) and 128 (the
padded 8 x 16 grid).  The packed bytes are drawn at random, so every
2-bit field occurs, the reserved 0b10 (decodes to 0) included, and the
activations cover the whole int8 range.  Scales are dyadic (k/8, input
scale 1/4) and the products stay far below 2^24, so every f32 step is
exact and the comparison is bit for bit, in f32 and in bf16.  On the
card the same wrapper launches the swap-AB wgmma kernel
(tests/test_torch_cuda.py holds it to this plain version).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.tim_matmul import tim_matmul_packed_pallas  # noqa: E402

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import tim_matmul as tk  # noqa: E402

K, N = 128, 48
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("need_t", [False, True])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 128])
def test_packed_single_plain_matches_pallas(m, dtypes, need_t):
    tdt, jdt = dtypes
    rng = np.random.default_rng(m)
    x = rng.integers(-128, 128, (m, K)).astype(np.int8)
    wp = rng.integers(0, 256, (K // 4, N)).astype(np.uint8)
    w1 = (rng.integers(1, 9, N) / 8).astype(np.float32)
    w2 = (rng.integers(1, 9, N) / 8).astype(np.float32)
    i1 = np.float32(0.25)
    ref = tim_matmul_packed_pallas(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(w1), jnp.asarray(w2),
        jnp.asarray(i1), need_t=need_t, out_dtype=jdt, interpret=True)
    # the path a CUDA call of this shape takes
    assert tk.tim_path("single", True, None, m, N, K, need_t=need_t) == \
        ("tc" if need_t else "wgmma")
    reset_launch_counts()
    ours = tk.tim_matmul_single(torch.from_numpy(x), torch.from_numpy(wp),
                                torch.from_numpy(w1), torch.from_numpy(w2),
                                torch.tensor(i1), packed=True, need_t=need_t,
                                out_dtype=tdt)
    assert not any(launch_counts().values())      # CPU: the plain version
    assert ours.dtype == tdt and ours.shape == (m, N)
    np.testing.assert_array_equal(_np(ours), _np(ref))

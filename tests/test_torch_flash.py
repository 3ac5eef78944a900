"""Port parity (flash attention): ``flash_attention_plain`` (the plain
version of the port's flash-attention kernel) against the reference's
``flash_attention_pallas`` in interpret mode, on the five shapes of
tests/test_flash_attention.py (causal and bidirectional, GQA, ragged
against the block sizes, Sq != Sk) and its bf16 case.  The plain
version runs once as one full-attention pass (Sk fits ``chunk_kv``) and
once as the online-softmax scan over 16-position chunks.  The Hopper
kernel itself is held against this plain version on the card
(tests/test_torch_cuda.py).

Tolerance: f32 in both, sums in other orders: 3e-5 (relative and
absolute), what tests/test_flash_attention.py holds the Pallas kernel
to against the dense oracle.  bf16: both accumulate in f32 and round
once to bf16, so they agree to one bf16 ulp: |diff| <= 2^-7 * |ref| +
2e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from test_flash_attention import CASES  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402,E501

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)


def _inputs(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hk, d)).astype(np.float32),
            rng.normal(size=(b, sk, hk, d)).astype(np.float32))


@pytest.mark.parametrize("chunk_kv", [1024, 16], ids=["full", "scan"])
@pytest.mark.parametrize("idx", range(len(CASES)))
def test_flash_plain_matches_pallas(idx, chunk_kv):
    b, sq, sk, h, hk, d, causal, bq, bk = CASES[idx]
    q, k, v = _inputs(b, sq, sk, h, hk, d, idx)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, block_q=bq,
                                  block_k=bk, interpret=True)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                chunk_kv=chunk_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("chunk_kv", [1024, 16], ids=["full", "scan"])
def test_flash_plain_bf16_matches_pallas(chunk_kv):
    q, k, v = _inputs(1, 32, 32, 2, 2, 16, 7)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=True, block_q=16, block_k=16, interpret=True),
        np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=True, chunk_kv=chunk_kv)
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want)
            <= np.abs(want) * 2.0 ** -7 + 2e-3).all()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_cpu_dispatch_runs_plain_and_counts_nothing(causal):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 17, 33, 4, 2, 8, 3))
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 0
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=causal))

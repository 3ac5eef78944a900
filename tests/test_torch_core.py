"""Port parity (core): packing, ternarization, activation codes, the
TernaryWeight container, TernaryPolicy and the configs — the PyTorch
port (``repro_torch``) against the JAX reference on shared numpy inputs.

Tolerances: codes, packed bytes and activation codes are bit-exact.
Ternarization codes are equal except where |w| lies within one bf16 ulp
of the threshold (the two frameworks reduce the bf16 mean in another
order); scales agree to 1 bf16 ulp.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (the reference engine's tests are timing-
# sensitive under this jax version, ROADMAP R1)
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import ternary as jT  # noqa: E402
from repro.core.weights import TernaryWeight as JTW  # noqa: E402
from repro.core.weights import ternarize_weight as j_ternarize_weight  # noqa: E402,E501
from repro.nn.linear import TernaryPolicy as JPolicy  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import ternary as tT  # noqa: E402
from repro_torch.core.weights import TernaryWeight, ternarize_weight  # noqa: E402,E501
from repro_torch.nn.linear import TernaryPolicy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16_np(t):
    """torch/jax bf16 -> float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("shape,axis", [((12, 8), 0), ((8, 12), -1),
                                        ((3, 16, 5), 1)])
def test_pack_unpack_bit_exact(shape, axis):
    rng = np.random.default_rng(0)
    q = rng.integers(-1, 2, shape).astype(np.int8)
    jp = np.asarray(jpack.pack2b(jnp.asarray(q), axis=axis))
    tp = tpack.pack2b(torch.from_numpy(q), axis=axis).numpy()
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(
        tpack.unpack2b(torch.from_numpy(tp), axis=axis).numpy(), q)


def test_reserved_field_decodes_to_zero():
    p = np.array([0b10101010], np.uint8)
    np.testing.assert_array_equal(
        tpack.unpack2b(torch.from_numpy(p)).numpy(),
        np.asarray(jpack.unpack2b(jnp.asarray(p))))


@pytest.mark.parametrize("encoding", ["unweighted", "symmetric",
                                      "asymmetric"])
@pytest.mark.parametrize("axis", [None, 0])
def test_ternarize_codes_match_off_threshold(encoding, axis):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 40)).astype(np.float32) * 0.05
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    wt = torch.from_numpy(w).bfloat16()
    qj, sj = jT.ternarize(wj, encoding, axis=axis)
    qt, st = tT.ternarize(wt, encoding, axis=axis)
    qj = np.asarray(qj)
    qt = qt.numpy()
    thr = _bf16_np(jT._threshold(wj, axis, jT.TWN_THRESHOLD_FACTOR))
    near = np.abs(np.abs(_bf16_np(wj)) - thr) <= thr * 2.0 ** -7
    assert ((qj == qt) | near).all()
    assert (qj == qt).mean() > 0.99
    for a, b in ((sj.pos, st.pos), (sj.neg, st.neg)):
        np.testing.assert_allclose(_bf16_np(b), _bf16_np(a), rtol=2 ** -7)
    assert st.sym == sj.sym


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("k", [64, 42])
def test_ternarize_weight_container(pack, k):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((k, 24)).astype(np.float32)
    jw = j_ternarize_weight(jnp.asarray(w), "asymmetric", pack=pack)
    tw = ternarize_weight(torch.from_numpy(w), "asymmetric", pack=pack)
    assert tw.shape == tuple(jw.shape)
    assert tw.packed == jw.packed and tw.k_dim == jw.k_dim
    assert tw.nbytes_hbm == jw.nbytes_hbm
    np.testing.assert_array_equal(tw.codes().numpy(), np.asarray(jw.codes()))
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_allclose(tw.dequantize().numpy(),
                               np.asarray(jw.dequantize()), rtol=1e-6)


def test_dequantize_bf16_matches():
    rng = np.random.default_rng(3)
    q = rng.integers(-1, 2, (16, 8)).astype(np.int8)
    pos = (rng.random(8) + 0.5).astype(np.float32)
    neg = (rng.random(8) + 0.5).astype(np.float32)
    js = jT.TernaryScales(jnp.asarray(pos).astype(jnp.bfloat16),
                          jnp.asarray(neg).astype(jnp.bfloat16))
    ts = tT.TernaryScales(torch.from_numpy(pos).bfloat16(),
                          torch.from_numpy(neg).bfloat16())
    ours = TernaryWeight(torch.from_numpy(q), ts).dequantize(torch.bfloat16)
    ref = JTW(jnp.asarray(q), js).dequantize(jnp.bfloat16)
    np.testing.assert_array_equal(_bf16_np(ours), _bf16_np(ref))
    np.testing.assert_array_equal(
        _bf16_np(tT.dequantize(torch.from_numpy(q), ts, torch.bfloat16)),
        _bf16_np(jT.dequantize(jnp.asarray(q), js, jnp.bfloat16)))


@pytest.mark.parametrize("bits", [2, 4, 7])
def test_activation_codes_bit_exact(bits):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 50)) * 0.8).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    qj, stepj = jT.quantize_act_unsigned(xj, bits)
    qt, stept = tT.quantize_act_unsigned(xt, bits)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    assert stept.dtype == torch.bfloat16
    assert float(stept) == float(stepj.astype(jnp.float32))
    qj, _ = jT.quantize_act_ternary(xj, 0.5)
    qt, st = tT.quantize_act_ternary(xt, 0.5)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    assert st.sym


def test_policy_mirrors_reference():
    for mode in ("none", "ternary", "int2", "int4", "int7"):
        assert TernaryPolicy(act_mode=mode).act_bits == \
            JPolicy(act_mode=mode).act_bits
    for bad in ("int1", "int8", "fp8"):
        with pytest.raises(ValueError):
            TernaryPolicy(act_mode=bad)
    tgt = TernaryPolicy(act_mode="int4")
    assert tgt.draft("int2").act_mode == "int2"
    for bad in ("none", "int7"):
        with pytest.raises(ValueError):
            tgt.draft(bad)
    off = TernaryPolicy(enabled=False)
    assert off.draft("int2") is off


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_reference(name, smoke):
    ours, ref = get_config(name, smoke), jget_config(name, smoke)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "ternary":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif f.name == "layout":
            assert [(x.mixer, x.ffn) for x in a] == \
                [(x.mixer, x.ffn) for x in b]
        else:
            assert a == b, f.name
    assert (ours.hd, ours.vocab_padded, ours.n_periods) == \
        (ref.hd, ref.vocab_padded, ref.n_periods)


def test_port_imports_without_jax_or_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.interop, "
        "repro_torch.serve.engine, repro_torch.kernels.ops, "
        "repro_torch.kernels.paged_attention, repro_torch.kernels.ref\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine, ternarize_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("chatglm3-6b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        tfm.init(cfg)
    params = tfm.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ternarize_model(params, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(params, cfg, batch_slots=1, max_len=32)

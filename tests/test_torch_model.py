"""Port parity (model): the dense transformer's mixed step through
``interop.params_from_numpy`` against the JAX reference, for the
granite-34b and chatglm3-6b smoke configs, bf16 and int8 KV.

Tolerances (bf16 logits of magnitude ~3):
  * weight-only serving (``act_mode='none'``), full depth: |diff| <=
    0.0625 — bf16 matmul and f32 reduction order differ between XLA and
    PyTorch;
  * TiM activation modes, one block at a time: the TiM matmuls are
    bit-exact, but an f32 reduction in another order can move an
    activation across a quantization boundary (0.5 for ternary codes, a
    rounding boundary for int4) and change that row's codes; such a
    flip then spreads through every later layer, so full depth is held
    by the greedy-token tests (test_torch_engine.py) instead.
Inside the port, the paged step equals the contiguous step bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU shapes: one thread, so parallel test workers do not
# oversubscribe the cores (the reference engine's tests are timing-
# sensitive under this jax version, ROADMAP R1)
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.weights import TernaryWeight as JTW  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.engine import ternarize_model as j_ternarize  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

MAX_LEN, BS = 64, 16


def to_numpy_tree(tree):
    """The reference's serving params as nested dicts of numpy arrays."""
    if isinstance(tree, JTW):
        return {"data": np.asarray(tree.data),
                "pos": np.asarray(tree.scales.pos),
                "neg": np.asarray(tree.scales.neg), "sym": tree.scales.sym,
                "packed": tree.packed, "k_dim": tree.k_dim}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def build(name, policy, kv="bfloat16", chunk_kv=1024):
    """(reference cfg, reference params, port cfg, port params); params
    are built once per (arch, policy, KV dtype) and never mutated."""
    key = (name, tuple(sorted(policy.items())), kv)
    if key not in _BUILT:
        _BUILT[key] = _build(name, policy, kv)
    jcfg, jp, cfg, tp = _BUILT[key]
    return (jcfg.replace(attn_chunk_kv=chunk_kv), jp,
            cfg.replace(attn_chunk_kv=chunk_kv), tp)


_BUILT = {}


def _build(name, policy, kv, seed=0):
    kw = dict(kv_cache_dtype=kv)
    jcfg = jget_config(name, smoke=True)
    jcfg = jcfg.replace(ternary=jcfg.ternary.replace(**policy), **kw)
    cfg = get_config(name, smoke=True)
    cfg = cfg.replace(ternary=cfg.ternary.replace(**policy), **kw)
    jp = j_ternarize(jtfm.init(jcfg, jax.random.PRNGKey(seed)), jcfg)
    return jcfg, jp, cfg, params_from_numpy(to_numpy_tree(jp), cfg, "cpu")


def _grid(rng, vocab):
    """Two mixed steps over 2 slots: prefill chunks, then a decode next
    to a continuing prefill (padding columns past n_new)."""
    toks = [rng.integers(0, vocab, (2, 8)).astype(np.int32),
            rng.integers(0, vocab, (2, 8)).astype(np.int32)]
    cache_len = [np.array([0, 0], np.int32), np.array([8, 5], np.int32)]
    n_new = [np.array([8, 5], np.int32), np.array([1, 3], np.int32)]
    return toks, cache_len, n_new


def _paged_meta(cache_len, n_new, s):
    nblk = MAX_LEN // BS
    tables = np.arange(2 * nblk, dtype=np.int32).reshape(2, nblk)
    pos = cache_len[:, None] + np.arange(s)[None]
    slot_map = tables[np.arange(2)[:, None], pos // BS] * BS + pos % BS
    slot_map = np.where(np.arange(s)[None] < n_new[:, None], slot_map,
                        2 * (nblk + 1) * BS).astype(np.int32)
    return tables, slot_map


def run_reference(jcfg, jp, steps):
    nb = 2 * (MAX_LEN // BS + 1)
    caches = jtfm.init_paged_caches(jcfg, 2, nb, BS)
    outs = []
    for toks, cl, nn in zip(*steps):
        tables, smap = _paged_meta(cl, nn, toks.shape[1])
        h, caches, _ = jtfm.forward(
            jp, jcfg, {"tokens": jnp.asarray(toks)}, mode="mixed",
            caches=caches, cache_len=jnp.asarray(cl), n_new=jnp.asarray(nn),
            block_tables=jnp.asarray(tables), slot_map=jnp.asarray(smap))
        outs.append(np.asarray(jtfm.logits(jp, jcfg, h).astype(jnp.float32)))
    return outs


def run_port(cfg, params, steps, paged=True):
    nb = 2 * (MAX_LEN // BS + 1)
    caches = tfm.init_paged_caches(cfg, 2, nb, BS, "cpu") if paged else \
        tfm.init_caches(cfg, 2, MAX_LEN, "cpu")
    outs = []
    for toks, cl, nn in zip(*steps):
        tables, smap = _paged_meta(cl, nn, toks.shape[1])
        kw = dict(block_tables=torch.from_numpy(tables),
                  slot_map=torch.from_numpy(smap)) if paged else {}
        h, caches, _ = tfm.forward(
            params, cfg, {"tokens": torch.from_numpy(toks)}, mode="mixed",
            caches=caches, cache_len=torch.from_numpy(cl),
            n_new=torch.from_numpy(nn), **kw)
        outs.append(tfm.logits(params, cfg, h).float().numpy())
    return outs


POLICIES = {
    "weight_only": dict(act_mode="none"),
    "int4_packed": dict(encoding="symmetric", act_mode="int4", pack=True),
    "ternary_asym": dict(encoding="asymmetric", act_mode="ternary",
                         pack=True),
}


def _one_layer(jcfg, jp, cfg, tp, layer):
    """Both models cut to the single block ``layer`` (same embedding,
    final norm and head), so a rounding flip cannot propagate."""
    jp = dict(jp, layers=jax.tree_util.tree_map(
        lambda a: a[layer:layer + 1], jp["layers"]))
    tp = dict(tp, layers=tp["layers"][layer:layer + 1])
    return jcfg.replace(n_layers=1), jp, cfg.replace(n_layers=1), tp


def _real_rows(outs, steps, vocab):
    return np.concatenate([
        o[np.arange(o.shape[1])[None] < nn[:, None]][:, :vocab]
        for o, nn in zip(outs, steps[2])])


@pytest.mark.parametrize("name", ["granite-34b", "chatglm3-6b"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_mixed_logits_match_reference_weight_only(name, kv):
    chunk_kv = 32 if kv == "int8" else 1024     # int8: the paged scan
    jcfg, jp, cfg, tp = build(name, POLICIES["weight_only"], kv, chunk_kv)
    steps = _grid(np.random.default_rng(0), cfg.vocab_size)
    ref = _real_rows(run_reference(jcfg, jp, steps), steps, cfg.vocab_size)
    ours = _real_rows(run_port(cfg, tp, steps), steps, cfg.vocab_size)
    assert np.abs(ref - ours).max() <= 0.0625


@pytest.mark.parametrize("name", ["granite-34b", "chatglm3-6b"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("policy", ["int4_packed", "ternary_asym"])
@pytest.mark.parametrize("layer", [0, 1])
def test_mixed_block_logits_match_reference_tim(name, kv, policy, layer):
    """TiM activation modes, one block at a time.  Two-phase layers are
    held against the reference's per-phase-rounding route
    (``fused=False``: each phase rounded to bf16 before the subtraction,
    the Pallas kernel's arithmetic, which the port follows); bit-serial
    layers against its fused route (one f32 epilogue, as the port).  An
    activation within an ulp of a quantization boundary may flip its code
    (f32 reductions run in another order): an int4 flip moves a logit by
    about one code step times a weight (<= 0.25 asserted; 0.125 seen), a
    ternary flip by a whole weight, so at most 2 of the 17 rows may then
    differ by more than 0.0625 (1 seen)."""
    chunk_kv = 32 if kv == "int8" else 1024
    jcfg, jp, cfg, tp = build(name, POLICIES[policy], kv, chunk_kv)
    jcfg = jcfg.replace(ternary=jcfg.ternary.replace(
        fused=policy != "ternary_asym"))
    jcfg, jp, cfg, tp = _one_layer(jcfg, jp, cfg, tp, layer)
    steps = _grid(np.random.default_rng(0), cfg.vocab_size)
    ref = _real_rows(run_reference(jcfg, jp, steps), steps, cfg.vocab_size)
    ours = _real_rows(run_port(cfg, tp, steps), steps, cfg.vocab_size)
    diff = np.abs(ref - ours)
    if policy == "int4_packed":
        assert diff.max() <= 0.25, diff.max()
    else:
        assert ((diff > 0.0625).any(-1)).sum() <= 2, diff.max(-1)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_paged_step_equals_contiguous_step(kv):
    _, _, cfg, tp = build("chatglm3-6b", POLICIES["int4_packed"], kv)
    steps = _grid(np.random.default_rng(1), cfg.vocab_size)
    paged = run_port(cfg, tp, steps, paged=True)
    contiguous = run_port(cfg, tp, steps, paged=False)
    for a, b in zip(paged, contiguous):
        np.testing.assert_array_equal(a, b)


def test_prefill_then_decode_matches_mixed():
    """The prefill + decode modes (contiguous caches) give the mixed
    step's logits for the same token history (bit for bit)."""
    _, _, cfg, tp = build("granite-34b", POLICIES["ternary_asym"])
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    caches = tfm.init_caches(cfg, 1, MAX_LEN, "cpu")
    h, caches, _ = tfm.forward(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                               mode="prefill", caches=caches)
    nxt = int(tfm.logits(tp, cfg, h[:, -1:]).argmax(-1))
    h2, _, _ = tfm.forward(tp, cfg, {"tokens": torch.tensor([[nxt]])},
                           mode="decode", caches=caches,
                           cache_len=torch.tensor([8], dtype=torch.int32))
    mixed = tfm.init_caches(cfg, 1, MAX_LEN, "cpu")
    hm, mixed, _ = tfm.forward(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                               mode="mixed", caches=mixed,
                               cache_len=torch.tensor([0], dtype=torch.int32))
    assert torch.equal(hm, h)
    hm2, _, _ = tfm.forward(tp, cfg, {"tokens": torch.tensor([[nxt]])},
                            mode="mixed", caches=mixed,
                            cache_len=torch.tensor([8], dtype=torch.int32))
    assert torch.equal(hm2, h2)


def test_padding_columns_never_write_the_pool():
    """A padding column (col >= n_new) must not touch the shared pool,
    even when its slot_map entry names a real position."""
    _, _, cfg, tp = build("chatglm3-6b", POLICIES["weight_only"])
    nb = 2 * (MAX_LEN // BS + 1)
    caches = tfm.init_paged_caches(cfg, 2, nb, BS, "cpu")
    tables, smap = _paged_meta(np.array([0, 0], np.int32),
                               np.array([3, 0], np.int32), 4)
    smap[1, :] = np.arange(4) + 5 * BS      # would land in block 5
    tfm.forward(tp, cfg, {"tokens": torch.ones((2, 4), dtype=torch.int32)},
                mode="mixed", caches=caches,
                cache_len=torch.tensor([0, 0], dtype=torch.int32),
                n_new=torch.tensor([3, 0], dtype=torch.int32),
                block_tables=torch.from_numpy(tables),
                slot_map=torch.from_numpy(smap))
    for layer in caches:
        assert not layer["k"][5].any() and not layer["v"][5].any()
        assert layer["k"][0, :3].any() and not layer["k"][0, 3:].any()

"""JAX oracle of a sampled rollout, for the port's sampled engine.

``reference_rollout``'s pattern (``tests/_serve_ref.py``: an unpadded
whole-prompt prefill, then one-token decodes) with each token drawn the
way the reference engine draws it:
``sample_token(lg, derive_sample_key(base, uid, sample_index, t), T)``.
Besides the tokens it returns, per token, the margin between the two
best perturbed scores (Gumbel noise + logits / T): where that margin is
small, cross-framework rounding of the logits may decide the draw.
The prefill and decode steps are jitted and cached per config.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import transformer as tfm
from repro.serve.engine import (derive_sample_key, make_decode_step,
                                make_prefill_step, sample_token)

_STEPS = {}


def _steps(cfg):
    if cfg not in _STEPS:
        _STEPS[cfg] = (jax.jit(make_prefill_step(cfg)),
                       jax.jit(make_decode_step(cfg)))
    return _STEPS[cfg]


def sampled_rollout(params, cfg, prompt, steps, max_len, seed, uid,
                    temperature=1.0, sample_index=0):
    """Returns (tokens, perturbed top-two margin per token)."""
    prefill, decode = _steps(cfg)
    base = jax.random.PRNGKey(seed)
    caches = tfm.init_caches(cfg, 1, max_len)
    lg, caches = prefill(params, {"tokens": jnp.asarray(prompt[None])},
                         caches)
    toks, margins = [], []
    clen = jnp.asarray([len(prompt)], jnp.int32)
    for t in range(steps):
        key = derive_sample_key(base, uid, sample_index, t)
        row = lg[0].astype(jnp.float32)
        tok = int(sample_token(row, key, temperature))
        scores = np.asarray(jax.random.gumbel(key, row.shape)
                            + row / temperature)
        assert tok == int(scores.argmax())
        top = np.sort(scores)[-2:]
        toks.append(tok)
        margins.append(float(top[1] - top[0]))
        if t + 1 < steps:
            lg, caches = decode(params, {"tokens": jnp.asarray(
                [[tok]], jnp.int32)}, caches, clen)
            clen = clen + 1
    return toks, margins

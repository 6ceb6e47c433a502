"""The port's batched check-head training (models/classifier.py:
CheckHeads, init_check_heads, train_check_heads) against the JAX
package's vmapped _train_check_head on the same inputs, initial
parameters (_init_mlp) and permutations (jax.random.permutation on the
trainer's own keys).

Tolerances, measured on the CPU: the two programs round their float32
GEMMs in different orders, and a rounding-level change that moves a row's
hidden pre-activation across the ReLU kink changes that step's gradient,
which Adam then carries on. After 20 steps the parameters agree within
5.3e-5 and the logits within 4.2e-5; after 60 steps (past the wrap of the
batch start at n = 5000) the parameters within 4.2e-4 and the logits
within 3.8e-4; the check bits on the training rows agree at both. The
tolerances below are about four times those."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.models import classifier as jclf
from hiprfish_tpu_torch.config import SEVEN_BIT
from hiprfish_tpu_torch.models import classifier as tclf
from hiprfish_tpu_torch.models import train as ttrain
from hiprfish_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

HIDDEN = 64
# the first three 7-bit blocks: widths 23, 20 and 14, padded to 23
BLOCKS = SEVEN_BIT.blocks[:3]
WMAX = 23
# (steps, parameter atol, logit atol)
TOL = {20: (2e-4, 2e-4), 60: (2e-3, 2e-3)}


def _head_data(n):
    """(H, n, 23) padded block inputs and (H, n) check bits of n rows of
    the 7-bit fixture's simulated spectra."""
    spectra, codes = tsyn.fixture_training_set(SEVEN_BIT, 50)
    idx = np.random.RandomState(1).choice(len(spectra), n, replace=False)
    x = np.zeros((len(BLOCKS), n, WMAX), np.float32)
    for h, (lo, hi) in enumerate(BLOCKS):
        x[h, :, :hi - lo] = spectra[idx, lo:hi]
    checks = ttrain.check_bits_for_codes(SEVEN_BIT, [codes[i] for i in idx])
    return x, np.ascontiguousarray(checks[:, :len(BLOCKS)].T)


def _reference_draws(n):
    """The JAX trainer's initial parameters and permutations, drawn as its
    train_classifier draws them from PRNGKey(0)."""
    keys = jax.random.split(jax.random.PRNGKey(0), len(BLOCKS) + 1)
    inits = [jclf._init_mlp(keys[b], WMAX, HIDDEN)
             for b in range(len(BLOCKS))]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *inits)
    pkeys = jax.random.split(keys[-1], len(BLOCKS))
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in pkeys])
    return stacked, pkeys, perms


@pytest.mark.parametrize("steps", [20, 60])
@pytest.mark.parametrize("n", [3000, 5000], ids=["n<bs", "n=5000-wraps"])
def test_train_check_heads_matches_the_reference(n, steps):
    x, y = _head_data(n)
    stacked, pkeys, perms = _reference_draws(n)
    want = jax.device_get(jclf._train_check_heads_batched(
        pkeys, jnp.asarray(x), jnp.asarray(y), stacked, steps, 3e-3))
    got = tclf.train_check_heads(
        torch.from_numpy(x), torch.from_numpy(y),
        {k: torch.from_numpy(np.array(v)) for k, v in stacked.items()},
        torch.from_numpy(perms).long(), steps, 3e-3)
    p_atol, l_atol = TOL[steps]
    for k in ("w1", "b1", "w2", "b2"):
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=p_atol, err_msg=k)
    logit_j = np.asarray(jax.vmap(jclf._mlp_logit)(want, jnp.asarray(x)))
    with torch.no_grad():
        logit_t = tclf.CheckHeads.from_params(got, "cpu")(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logit_t, logit_j, rtol=0, atol=l_atol)
    np.testing.assert_array_equal(logit_t > 0, logit_j > 0)


def test_check_heads_forward_equals_the_reference_mlp():
    x, _ = _head_data(500)
    stacked, _, _ = _reference_draws(500)
    want = np.asarray(jax.vmap(jclf._mlp_logit)(stacked, jnp.asarray(x)))
    params = {k: torch.from_numpy(np.array(v)) for k, v in stacked.items()}
    heads = tclf.CheckHeads.from_params(params, "cpu")
    assert heads.w1.shape == (3, WMAX, HIDDEN)
    assert heads.w2.shape == (3, HIDDEN, 1)
    with torch.no_grad():
        got = heads(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # one head of the stack is the inference CheckHead of the same arrays
    one = tclf.CheckHead.from_numpy({k: np.array(v)[1]
                                     for k, v in stacked.items()}, "cpu")
    np.testing.assert_allclose(one(torch.from_numpy(x[1])).numpy(),
                               got[1], rtol=0, atol=1e-6)


def test_init_check_heads_scales():
    init = tclf.init_check_heads(torch.Generator().manual_seed(0), 6, 32,
                                 HIDDEN)
    assert init["w1"].shape == (6, 32, HIDDEN)
    assert init["w2"].shape == (6, HIDDEN, 1)
    assert not init["b1"].any() and not init["b2"].any()
    assert abs(float(init["w1"].std()) - np.sqrt(2 / 32)) < 0.01
    assert abs(float(init["w2"].std()) - np.sqrt(1 / HIDDEN)) < 0.02

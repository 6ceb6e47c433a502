"""The port's spectra simulation (hiprfish_tpu_torch/models/simulate.py and
the simulation core of models/train.py) against the JAX package's: the
numpy helpers bit for bit, the random functions' deterministic cores on
the JAX package's own draws within 1e-6, and the port's own draws against
the distribution they sample."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN, TEN_BIT as JTEN
from hiprfish_tpu.models import simulate as jsim
from hiprfish_tpu.models import train as jtrain
from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
from hiprfish_tpu_torch.models import simulate as tsim
from hiprfish_tpu_torch.models import train as ttrain

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _covs(k, c, rows, seed=0):
    """(k, c, c) sample covariances of ``rows`` rows each (rank-deficient
    when rows <= c)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(k, rows, c)
    return np.stack([np.cov(xi.T) for xi in x])


def test_numpy_copies_bit_equal():
    covs = _covs(3, 12, 8)
    np.testing.assert_array_equal(tsim.psd_sqrt(covs), jsim.psd_sqrt(covs))
    np.testing.assert_array_equal(tsim.EXCITATION_MATRIX_7B,
                                  jsim.EXCITATION_MATRIX_7B)
    assert tsim.MOLAR_EXTINCTION == jsim.MOLAR_EXTINCTION
    assert tsim.QUANTUM_YIELD == jsim.QUANTUM_YIELD
    for a, b in zip(tsim.default_fluorophore_curves(),
                    jsim.default_fluorophore_curves()):
        np.testing.assert_array_equal(a, b)
    for d in (5.0, 6.37, 9.9):
        np.testing.assert_array_equal(tsim.fret_transfer_matrix(d),
                                      jsim.fret_transfer_matrix(d))


def test_reference_stats_and_check_bits_equal(tmp_path):
    from hiprfish_tpu_torch.utils import synthetic as tsyn

    tsyn.write_reference_folder(TEN_BIT, str(tmp_path), [3, 96, 1023],
                                cells_per_code=7, seed=2)
    got = ttrain.load_reference_stats(str(tmp_path))
    want = jtrain.load_reference_stats(str(tmp_path))
    assert sorted(got) == sorted(want)
    for e in got:
        np.testing.assert_array_equal(got[e][0], want[e][0])
        np.testing.assert_array_equal(got[e][1], want[e][1])
    for layout, jlayout, codes in (
            (TEN_BIT, JTEN, ["0000000101", "1111111111_error"]),
            (SEVEN_BIT, JSEVEN, ["0000001", "1010101", "0110000_error"])):
        np.testing.assert_array_equal(
            ttrain.check_bits_for_codes(layout, codes),
            jtrain.check_bits_for_codes(jlayout, codes))


def test_row_max_normalize_and_violet_derivative_equal():
    x = np.random.RandomState(1).rand(9, 95).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_array_equal(
        tsim.row_max_normalize(_t(x)).numpy(),
        np.asarray(jsim.row_max_normalize(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tsim.violet_derivative(_t(x), (0, 32)).numpy(),
        np.asarray(jsim.violet_derivative(jnp.asarray(x), (0, 32))))


@pytest.mark.parametrize("which", ["excitation_adjust", "dim_blocks"])
def test_block_scaling_on_the_reference_draws(which):
    n = 50
    x = np.random.RandomState(2).rand(n, 95).astype(np.float32)
    blocks = TEN_BIT.blocks
    key = jax.random.PRNGKey(4)
    # the reference draws one (n, 1) uniform per block from split keys
    u = np.stack([np.asarray(jax.random.uniform(k, (n, 1)))
                  for k in jax.random.split(key, len(blocks))])
    if which == "excitation_adjust":
        want = jsim.excitation_adjust(key, jnp.asarray(x), blocks, 0.4, 1.0)
        got = tsim.excitation_adjust_core(_t(x), blocks, 0.4, 1.0, _t(u))
    else:
        scales = [0.4, 0.3, 0.2, 0.1, 0.5]
        want = jsim.dim_blocks(key, jnp.asarray(x), blocks, scales)
        got = tsim.dim_blocks_core(_t(x), blocks, scales, _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_simulate_codes_on_the_reference_draws():
    stats = {e: (np.random.RandomState(e).rand(95) + 0.5, c)
             for e, c in zip((7, 300, 1000), _covs(3, 95, 30, seed=5))}
    key = jax.random.PRNGKey(3)
    spc = 40
    encs_j, want = jtrain._simulate_codes(key, stats, spc)
    z = jax.random.normal(key, (3, spc, 95), jnp.float32)
    encs = sorted(stats)
    means = np.stack([stats[e][0] for e in encs]).astype(np.float32)
    sqrts = tsim.psd_sqrt(np.stack([stats[e][1] for e in encs])
                          .astype(np.float32))
    got = ttrain.simulate_codes_core(_t(means), _t(sqrts), _t(z))
    np.testing.assert_allclose(got.reshape(-1, 95).numpy(), want, rtol=0,
                               atol=1e-6)
    encs_t, draws = ttrain._simulate_codes(torch.Generator().manual_seed(0),
                                           stats, spc, device="cpu")
    np.testing.assert_array_equal(encs_t, encs_j)
    assert draws.shape == want.shape and draws.dtype == torch.float32


def test_mvnormal_and_fret_cores_on_the_reference_draws():
    rng = np.random.RandomState(6)
    mean = rng.rand(63).astype(np.float32)
    cov = _covs(1, 63, 40, seed=7)[0]
    key = jax.random.PRNGKey(8)
    want = jsim.mvnormal(key, jnp.asarray(mean), cov, 30)
    z = jax.random.normal(key, (30, 63), dtype=jnp.float32)
    got = tsim.mvnormal_core(_t(mean), _t(tsim.psd_sqrt(cov)), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)

    bits = np.array([1, 0, 1, 1, 0, 0, 1], np.float32)
    means = rng.rand(7, 63).astype(np.float32)
    chols = tsim.psd_sqrt(_covs(7, 63, 20, seed=9) * 0.01)
    fret = np.stack([tsim.fret_transfer_matrix(d) for d in (6.0, 7.5, 9.0)]
                    ).astype(np.float32)
    want = jsim.simulate_fret_code_spectra(
        key, jnp.asarray(bits), jnp.asarray(means), jnp.asarray(chols),
        jnp.asarray(fret), jnp.asarray(jsim.EXCITATION_MATRIX_7B),
        JSEVEN.blocks, 3)
    z = jnp.stack([jax.random.normal(k, (3, 63), jnp.float32)
                   for k in jax.random.split(key, 7)])
    got = tsim.simulate_fret_code_spectra_core(
        _t(bits), _t(means), _t(chols), _t(fret),
        _t(tsim.EXCITATION_MATRIX_7B), SEVEN_BIT.blocks, _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_draws_follow_the_measured_mean_and_covariance():
    # two codes of 12 channels, 20,000 draws each: the sample mean lies
    # within 5 standard errors of the measured one, the sample covariance
    # within 0.05 of the measured (rank-deficient) one's scale
    covs = _covs(2, 12, 9, seed=11)
    stats = {1: (np.linspace(0.2, 1.0, 12), covs[0]),
             2: (np.linspace(1.0, 0.2, 12), covs[1])}
    spc = 20000
    gen = torch.Generator().manual_seed(5)
    encs, draws = ttrain._simulate_codes(gen, stats, spc, device="cpu")
    draws = draws.numpy().astype(np.float64)
    for i, e in enumerate((1, 2)):
        d = draws[i * spc:(i + 1) * spc]
        mean, cov = stats[e]
        se = np.sqrt(np.diag(cov) / spc)
        assert np.all(np.abs(d.mean(axis=0) - mean) < 5 * se + 1e-7)
        assert np.abs(np.cov(d.T) - cov).max() < 0.05 * np.abs(cov).max()
    # the excitation scale and the dimming are uniform on their ranges
    x = torch.ones((spc, 95))
    adj = tsim.excitation_adjust(gen, x, TEN_BIT.blocks, 0.4, 1.0)
    assert 0.4 <= float(adj.min()) and float(adj.max()) <= 1.0
    assert abs(float(adj[:, 0].mean()) - 0.7) < 0.01
    dim = tsim.dim_blocks(gen, x, TEN_BIT.blocks, [0.4] * 5)
    assert abs(float(dim[:, 40].mean()) - 0.2) < 0.005

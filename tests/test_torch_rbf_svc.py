"""TorchRbfSvc (hiprfish_tpu_torch/models/artifacts.py) against the JAX
package's JaxRbfSvc and sklearn, on the same fitted SVCs:

- binary, 3-, 12- and 40-class and string classes: RBF kernels within
  1e-6 and one-vs-one decisions within 1e-5 (or 1e-6 x the dual
  coefficients' largest sum of magnitudes) of JaxRbfSvc's, predictions
  equal to both;
- predict_proba within 1e-6 of JaxRbfSvc's on the same decisions (its
  Platt + Wu-Lin-Weng float64 loop), within 1e-4 end to end and within
  5e-3 of sklearn's;
- the vectorised one-vs-one (per-class partial sums, then a gather per
  pair) equal to the JAX package's pair loop, ported verbatim below, up to
  float32 summation order, with the same signs.
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn import svm

from hiprfish_tpu.models.artifacts import JaxRbfSvc
from hiprfish_tpu_torch.models.artifacts import TorchRbfSvc

torch.set_num_threads(1)


def _fit(n_classes, seed, probability=False, strings=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(30 * n_classes, 10)
    y = np.minimum((x[:, 0] * n_classes).astype(int), n_classes - 1)
    if strings:
        y = np.array([format(v + 1, "010b") for v in y])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        clf = svm.SVC(C=10, gamma=0.5, probability=probability,
                      random_state=0).fit(x, y)
    return clf, rng.rand(60, 10)


def _pair_loop(svc: TorchRbfSvc, x):
    """JaxRbfSvc.decision_function_ovo's double loop over the pairs, in
    torch."""
    kern = svc._kernel(x)
    starts = np.concatenate([[0], np.cumsum(svc.n_support)])
    dec, p = [], 0
    k = len(svc.classes)
    for i in range(k):
        for j in range(i + 1, k):
            ki = kern[:, starts[i]:starts[i + 1]]
            kj = kern[:, starts[j]:starts[j + 1]]
            ci = svc.dual_coef[j - 1, starts[i]:starts[i + 1]]
            cj = svc.dual_coef[i, starts[j]:starts[j + 1]]
            dec.append(ki @ ci + kj @ cj + svc.intercept[p])
            p += 1
    return torch.stack(dec, dim=1)


@pytest.mark.parametrize("n_classes,strings", [(2, False), (3, False),
                                               (12, False), (40, False),
                                               (2, True), (12, True)])
def test_decisions_and_predictions_match_jax(n_classes, strings):
    clf, xt = _fit(n_classes, n_classes, strings=strings)
    ours = TorchRbfSvc.from_pickled(clf, "cpu")
    ref = JaxRbfSvc.from_sklearn(clf)
    dec = ours.decision_function_ovo(xt)
    assert dec.shape == (60, n_classes * (n_classes - 1) // 2)
    # the kernels agree within a few ulps of 1 (the x2 + s2 - 2 x.sv
    # form's sums run in other orders); a pair's decision adds them
    # weighted by its dual coefficients (|c| <= C = 10), so it is held to
    # 1e-5 or 1e-6 x the largest sum of |c| over a pair's support vectors
    x = np.asarray(xt, np.float32)
    d2 = (np.sum(x * x, 1)[:, None] + np.sum(ref.sv * ref.sv, 1)[None, :]
          - 2.0 * x @ ref.sv.T)
    kern = np.exp(-ref.gamma * np.maximum(d2, 0.0))
    np.testing.assert_allclose(ours._kernel(xt).numpy(), kern, rtol=0,
                               atol=1e-6)
    weight = np.abs(ref.dual_coef).sum(axis=1).max()
    np.testing.assert_allclose(dec.numpy(),
                               np.asarray(ref.decision_function_ovo(xt)),
                               rtol=0, atol=max(1e-5, 1e-6 * weight))
    pred = ours.predict(xt)
    np.testing.assert_array_equal(pred, np.asarray(ref.predict(xt)))
    np.testing.assert_array_equal(pred, clf.predict(xt))


@pytest.mark.parametrize("n_classes", [12, 40])
def test_vectorised_ovo_equals_pair_loop(n_classes):
    clf, xt = _fit(n_classes, 100 + n_classes)
    ours = TorchRbfSvc.from_pickled(clf, "cpu")
    loop = _pair_loop(ours, xt)
    vec = ours.decision_function_ovo(xt)
    # a class's partial sum is one GEMM column here and a GEMV in the
    # loop: float32 sums of up to sum |c| in other orders
    weight = float(ours.dual_coef.abs().sum(dim=1).max())
    np.testing.assert_allclose(vec.numpy(), loop.numpy(), rtol=0,
                               atol=max(1e-5, 1e-6 * weight))
    assert torch.equal(vec > 0, loop > 0)


@pytest.mark.parametrize("n_classes", [3, 12])
def test_predict_proba_matches_jax_and_sklearn(n_classes):
    clf, xt = _fit(n_classes, 200 + n_classes, probability=True)
    ours = TorchRbfSvc.from_pickled(clf, "cpu")
    ref = JaxRbfSvc.from_sklearn(clf)
    got = ours.predict_proba(xt)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, clf.predict_proba(xt), rtol=0,
                               atol=5e-3)
    # the float64 sigmoid and coupling on the same decisions
    dec = np.asarray(ref.decision_function_ovo(xt))
    ref.decision_function_ovo = lambda x: dec
    ours.decision_function_ovo = lambda x: torch.from_numpy(dec)
    np.testing.assert_allclose(ours.predict_proba(xt),
                               ref.predict_proba(xt), rtol=0, atol=1e-6)
    # end to end, the decisions' float32 roundings (test above) move the
    # sigmoids by |probA| x 1e-5
    np.testing.assert_allclose(got, ref.predict_proba(xt), rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError, match="probability"):
        TorchRbfSvc.from_pickled(_fit(3, 1)[0], "cpu").predict_proba(xt)

"""The port's numpy ``macro_ap_roc`` against the JAX package's (sklearn's
``average_precision_score`` and ``roc_auc_score``, macro-averaged over
the columns with both classes present), to 1e-12."""

import numpy as np
import pytest

from maest_tpu.train.metrics import macro_ap_roc as sklearn_macro_ap_roc
from maest_tpu_torch.train import gather_across_hosts
from maest_tpu_torch.train.metrics import macro_ap_roc

TOL = dict(rtol=0, atol=1e-12)


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    y = (rng.random((60, 9)) < 0.3).astype("f4")
    s = rng.random((60, 9))
    if kind == "ties":  # scores on a 0.1 grid: many tied thresholds
        s = np.round(s, 1)
    if kind == "degenerate-columns":
        y[:, 2] = 0.0  # no positives
        y[:, 5] = 1.0  # no negatives
    if kind == "logits":  # sigmoid of float32 logits, as the eval feeds it
        z = rng.standard_normal((60, 9)).astype("f4") * 3
        s = 1.0 / (1.0 + np.exp(-z))
    return y, s


@pytest.mark.parametrize("kind", ["random", "ties", "degenerate-columns",
                                  "logits"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_macro_ap_roc_matches_sklearn(kind, seed):
    y, s = _case(kind, seed)
    ours = macro_ap_roc(y, s)
    ref = sklearn_macro_ap_roc(y, s)
    np.testing.assert_allclose(ours, ref, **TOL)
    assert 0.0 < ours[0] <= 1.0 and 0.0 <= ours[1] <= 1.0


def test_all_degenerate_gives_nan():
    y = np.zeros((5, 3), "f4")
    y[:, 1] = 1.0  # every column all-negative or all-positive
    s = np.random.default_rng(0).random((5, 3))
    ours, ref = macro_ap_roc(y, s), sklearn_macro_ap_roc(y, s)
    assert np.isnan(ours).all() and np.isnan(ref).all()


def test_perfect_and_reversed_rankings():
    y = np.array([[1, 0], [1, 0], [0, 1], [0, 1]], "f4")
    s = np.array([[0.9, 0.1], [0.8, 0.2], [0.3, 0.7], [0.2, 0.6]])
    for scores in (s, 1.0 - s):
        np.testing.assert_allclose(macro_ap_roc(y, scores),
                                   sklearn_macro_ap_roc(y, scores), **TOL)
    assert macro_ap_roc(y, s) == (1.0, 1.0)


def test_gather_across_hosts_is_the_identity_for_one_process():
    a = np.arange(6).reshape(3, 2)
    assert gather_across_hosts(a) is a

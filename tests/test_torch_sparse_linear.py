"""The slice as a whole on the CPU: sparse logistic regression and the
embedding-bag layer (``tools/profile_sparse.py``'s two legs, the
workload of the reference's ``example/sparse/linear_classification``)
through ``LibSVMIter``, ``nd.sparse``, the store's sparse push and
``row_sparse_pull`` and the lazy SGD and Adam rows, in both packages
with the same code, at 5,000 features, batch 64 and width 8, for 3
steps from the same seeded LibSVM file.

Bounds: the pushed gradient's row ids equal at every step (the same
float32 sums, in the same order); the logits within rtol 1e-5 (atol
1e-7) and every weight within rtol 1e-5 (atol 1e-6) of the JAX
package's. The two packages' dense head (a K = 8 product) rounds its
sums in different orders, ulps apart; Adam divides by the root of the
second moment, so where a gradient sums to near zero that ulp moves a
weight by up to ~4e-5 of Adam's step (lr 0.01): 3.8e-7 in the embedding
leg, hence the weights' atol.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import profile_sparse as ps

FEATURES, BATCH, WIDTH, STEPS = 5000, 64, 8, 3
RTOL, ATOL, W_ATOL = 1e-5, 1e-7, 1e-6


@pytest.fixture(scope="module")
def libsvm(tmp_path_factory):
    path = tmp_path_factory.mktemp("sparse_linear") / "train.libsvm"
    return ps.write_libsvm(str(path), 4 * BATCH, FEATURES, seed=0)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("leg", ["linear", "embedding"])
def test_leg_matches_jax(libsvm, leg, opt):
    init = ps.embedding_init(FEATURES, WIDTH, seed=0)
    t = ps.run_steps(ps.make_leg(mx, leg, mx.cpu(), libsvm, opt, FEATURES,
                                 BATCH, init), STEPS)
    j = ps.run_steps(ps.make_leg(jmx, leg, None, libsvm, opt, FEATURES,
                                 BATCH, init), STEPS)
    assert len(t["row_ids"]) == STEPS
    for a, b in zip(t["row_ids"], j["row_ids"]):
        onp.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == onp.int32
    for a, b in zip(t["logits"], j["logits"]):
        onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert len(t["weights"]) == len(j["weights"])
    for a, b in zip(t["early_weights"], t["weights"]):
        onp.testing.assert_array_equal(a, b)  # kept after the last step
    for a, b in zip(t["weights"], j["weights"]):
        onp.testing.assert_allclose(a, b, rtol=RTOL, atol=W_ATOL)
    assert t["unique_rows"] == j["unique_rows"]
    # the lazy update moved exactly the rows the batches touched
    w0 = onp.zeros((FEATURES, 1), "f") if leg == "linear" else init[0]
    moved = onp.nonzero((t["weights"][0] != w0).any(axis=1))[0]
    touched = onp.unique(onp.concatenate(t["row_ids"]))
    assert set(moved.tolist()) <= set(touched.tolist())
    assert len(moved) > 0.9 * len(touched)


def test_card_comparison_reads_what_the_smoke_gates():
    a = {"row_ids": [onp.arange(3, dtype="i4")], "logits": [onp.ones(4)],
         "early_weights": [onp.ones((2, 2))]}
    b = {"row_ids": [onp.arange(3, dtype="i4")],
         "logits": [onp.ones(4) * (1 + 1e-7)],
         "early_weights": [onp.ones((2, 2))]}
    c = ps.compare(a, b)
    assert c["row_ids_equal"] and c["logits_rel_l2"] < 1e-6
    b["row_ids"] = [onp.array([0, 2, 1], "i4")]
    assert not ps.compare(a, b)["row_ids_equal"]

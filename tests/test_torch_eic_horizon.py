"""The port's EIC horizon (``dcfp_tpu_torch/prune/horizon.py``) against
``tools/exp_eic_horizon.py`` and ``dcfp_tpu``, on the CPU.

The statistics equal the tool's within 1e-12 and its keep-masks
exactly; the stream is byte-equal to ``tests/test_convergence.py``'s;
20 steps of the port, its perturbed twin and the JAX package
(``tests/torch_eic_horizon.py``) start from the same loss (rtol 1e-4)
and pass ``check_rows`` at steps 10 and 20.  The full horizon is
opt-in, like ``tests/test_eic_horizon.py``:

    DCFP_TORCH_EIC_HORIZON_STEPS=2000 python -m pytest \\
        tests/test_torch_eic_horizon.py -m slow
"""

import os

import numpy as np
import pytest

from dcfp_tpu.prune.trace import trace_topology as j_trace_topology
from dcfp_tpu_torch.prune import horizon
from dcfp_tpu_torch.prune.eic import prunable_bn_names
from dcfp_tpu_torch.prune.trace import trace_topology
from tests import test_convergence as jconv
from tests import torch_eic_horizon as side
from tools import exp_eic_horizon as jtool

STEPS = os.environ.get("DCFP_TORCH_EIC_HORIZON_STEPS")


@pytest.fixture(scope="module")
def graphs():
    return jconv.build_our_model().graph, horizon.build_horizon_model(64).graph


def _random_eic(graph, seed):
    """Scores shaped like the convergence graph's EIC: exponential, a
    third of the channels never flagged (0), one layer all 0."""
    rng = np.random.default_rng(seed)
    names = sorted(prunable_bn_names(graph))
    eic = {}
    for i, n in enumerate(names):
        ch = graph.node(n).attrs["channels"]
        v = rng.exponential(1e-4 * (1 + i % 7), ch)
        v[rng.random(ch) < 0.33] = 0.0
        eic[n] = v if i != 5 else np.zeros(ch)
    return names, eic


def _jitter(eic, seed, scale):
    rng = np.random.default_rng(seed)
    return {n: np.where(v > 0, v * (1 + scale * rng.standard_normal(v.size)),
                        0.0) for n, v in eic.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statistics_match_the_tool(graphs, seed):
    jgraph, tgraph = graphs
    names, a = _random_eic(tgraph, seed)
    b = _jitter(a, seed + 100, 0.5)
    for rank in (False, True):
        got = horizon.within_layer_corr(a, b, names, rank=rank)
        want = jtool.within_layer_corr(a, b, names, rank=rank)
        assert abs(got - want) <= 1e-12, (rank, got, want)
    # exp_eic_horizon.py:186-188
    want = float(np.corrcoef([np.asarray(a[n]).mean() for n in names],
                             [np.asarray(b[n]).mean() for n in names])[0, 1])
    assert abs(horizon.layer_mean_corr(a, b, names) - want) <= 1e-12
    ttopo, jtopo = trace_topology(tgraph), j_trace_topology(jgraph)
    masks = []
    for eic in (a, b):
        got = horizon.masks_for(eic, tgraph, ttopo)
        want = jtool.masks_for(eic, jgraph, jtopo)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        masks.append(got)
    agree = horizon.mask_agreement(*masks)
    assert abs(agree - jtool.mask_agreement(*masks)) <= 1e-12
    assert 0.0 < agree < 1.0


def test_stream_is_the_convergence_tests():
    got = horizon.make_pretrain_batches(6)
    want = jconv.make_pretrain_batches(6)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("img", "label"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes(), k
    big = horizon.make_pretrain_batches(2, hw=65, batch=3)
    assert big[1]["img"].shape == (3, 65, 65, 3)
    assert big[1]["label"].shape == (3, 65, 65)


def test_horizon_20_steps_against_jax():
    """20 steps: the port's first loss is JAX's (rtol 1e-4), and the port
    against JAX sits at the port's self-noise floor at steps 10 and 20."""
    res = side.side_by_side(20, checkpoints=[10, 20])
    loss = res["losses"]
    np.testing.assert_allclose(loss["port"][0], loss["jax"][0], rtol=1e-4)
    assert all(np.isfinite(v).all() for v in loss.values())
    assert [r["steps"] for r in res["rows"]] == [10, 20]
    horizon.check_rows(res["rows"])


def test_card_horizon_wiring_on_the_cpu():
    """``card_horizon`` with ``device='cpu'`` at 2 x 33^2: the CPU has no
    TF32, so its 'tf32' run is the f32 run, bit for bit, and the floor
    is not."""
    res = horizon.card_horizon(2, 33, 2, [1, 2], device="cpu")
    assert res["device"] == "cpu" and res["batch"] == [2, 33, 33]
    assert set(res["runs"]) == set(horizon.RUNS)
    assert res["runs"]["tf32"] == {**res["runs"]["f32"], "median_step_ms":
                                   res["runs"]["tf32"]["median_step_ms"]}
    assert res["runs"]["f32_floor"]["first_losses"] != \
        res["runs"]["f32"]["first_losses"]
    for row in res["rows"] + res["rows_f32_own_floor"]:
        assert abs(row["pearson_ref"] - 1.0) <= 1e-12, row
        assert row["mask_agree_ref"] == 1.0, row
        assert row["pearson_floor"] < 1.0, row
    assert res["rows"] == res["rows_f32_own_floor"]


ROW = {"steps": 100, "pearson_ref": 0.65, "pearson_floor": 0.70,
       "spearman_ref": 0.60, "spearman_floor": 0.62,
       "layer_mean_corr": 0.999, "mask_agree_ref": 0.85,
       "mask_agree_floor": 0.86}


@pytest.mark.parametrize("bad", [
    {"pearson_ref": 0.59}, {"spearman_ref": 0.51},
    {"mask_agree_ref": 0.819}, {"layer_mean_corr": 0.95}])
def test_check_rows_gates(bad):
    horizon.check_rows([ROW, dict(ROW, steps=200)])
    row = dict(ROW, steps=200, **bad)
    with pytest.raises(AssertionError, match="'steps': 200"):
        horizon.check_rows([ROW, row])
    with pytest.raises(AssertionError, match="'steps': 200"):
        horizon.check_row(row)


def test_check_rows_gap_must_not_grow():
    # first gap 0.05; a last gap of 0.08 is inside the per-row gates
    last = dict(ROW, steps=200, pearson_ref=0.62)
    horizon.check_row(last)
    with pytest.raises(AssertionError):
        horizon.check_rows([ROW, last])
    horizon.check_rows([ROW, dict(last, pearson_ref=0.635)])


def test_check_card_loss_must_fall():
    run = {"median_step_ms": 1.0, "first_losses": [3.0] * 10,
           "last_losses": [2.0] * 10}
    res = {"rows": [ROW], "runs": {"f32": run, "tf32": run}}
    horizon.check_card(res)
    res["runs"]["tf32"] = dict(run, last_losses=[3.0] * 10)
    with pytest.raises(AssertionError, match="tf32"):
        horizon.check_card(res)


@pytest.mark.slow
@pytest.mark.skipif(not STEPS, reason="opt-in: set "
                    "DCFP_TORCH_EIC_HORIZON_STEPS")
def test_eic_horizon_full():
    res = side.side_by_side(int(STEPS))
    horizon.check_rows(res["rows"])

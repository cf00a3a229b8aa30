"""The harness's arithmetic: percentile, idle share, roofline totals,
busy time and idle gaps, and the frozen bound formulas."""
import numpy as np
import pytest

from simbench import run
from simbench.bounds import list_layer, spa_layer
from simbench.metrics import reader

SPA = {"decoder": {"dtype": "float32", "nm": 0, "nboper": 0}}
LIST = {"decoder": {"dtype": "bfloat16", "nm": 32, "nboper": 64}}


def test_bounds_match_known_values():
    # chip_smoke.spa_layer_bound_ms / list_layer_bound_ms at F = 128
    assert spa_layer.bound_ms(128, 1350, 4, 256, SPA) == pytest.approx(
        0.8452, abs=5e-5)
    assert list_layer.bound_ms(128, 1350, 4, 256, LIST) == pytest.approx(
        0.2517, abs=5e-5)
    assert list_layer.staircase_pairs(32, 64) == 216
    bf16 = {"decoder": dict(SPA["decoder"], dtype="bfloat16")}
    assert spa_layer.bound_ms(128, 1350, 4, 256, bf16) == pytest.approx(
        0.4226, abs=5e-5)


@pytest.mark.parametrize("n", [1, 19, 20, 21, 100, 400])
def test_p95_nearest_rank(n):
    xs = list(np.random.default_rng(n).permutation(n) + 1.0)
    # the smallest value with at least 95% of the values at or below it
    want = min(x for x in xs if sum(y <= x for y in xs) >= 0.95 * n)
    assert run.p95(xs) == want


def test_split_means_skip_batches_not_queued():
    splits = [dict(gen_ms=8.0, decode_ms=20.0, idle_pct=2.0, queued=True),
              dict(gen_ms=9.0, decode_ms=22.0, idle_pct=4.0, queued=True),
              dict(gen_ms=50.0, decode_ms=50.0, idle_pct=50.0, queued=False)]
    r = {"splits": splits}
    assert reader("gen_ms")(r) == pytest.approx(8.5)
    assert reader("decode_ms")(r) == pytest.approx(21.0)
    assert reader("idle_pct")(r) == pytest.approx(3.0)
    assert reader("gen_ms")({"splits": []}) is None


def test_avg_it_over_window():
    c = np.array([[128, 0, 0, 0, 600, 9], [128, 1, 3, 0, 500, 20]])
    assert reader("avg_it")({"counters": c}) == pytest.approx(1100 / 256)


def _profile(iters_per_batch, layers, ms_per_launch, name="spa_row_kernel"):
    kernels, ts = [], 0.0
    for iters in iters_per_batch:
        for s in range(int(iters.max())):
            for _ in layers:
                kernels.append((ts, ms_per_launch * 1e3, name))
                ts += 2e3
    return {"kernels": kernels, "iters": iters_per_batch}


def test_roofline_with_varying_active_frames():
    iters = [np.array([1, 3, 3, 0]), np.array([2, 2, 5, 1])]
    layers = [10, 10, 12]
    run_rec = {"profile": _profile(iters, layers, 0.5), "config": SPA,
               "shape": {"layers": layers, "dc": 4, "q": 256}}
    want_bound = 0.0
    for it in iters:
        for s in range(int(it.max())):
            f = int((it > s).sum())
            want_bound += sum(spa_layer.bound_ms(f, g, 4, 256, SPA)
                              for g in layers)
    launches = sum(int(it.max()) for it in iters) * len(layers)
    got = reader("k2_roofline_pct")(run_rec)
    assert got == pytest.approx(100 * want_bound / (launches * 0.5))
    # active frames fall step by step, so the bound does too
    assert reader("k3_roofline_pct")(run_rec) is None


def test_roofline_refuses_a_launch_count_it_cannot_place():
    iters = [np.array([2, 2])]
    prof = _profile(iters, [5, 5, 5], 0.1)
    prof["kernels"] = prof["kernels"][:-1]
    r = {"profile": prof, "config": SPA,
         "shape": {"layers": [5, 5, 5], "dc": 4, "q": 256}}
    assert reader("k2_roofline_pct")(r) is None


def test_busy_and_gaps():
    kernels = [(0.0, 10.0, "a"), (5.0, 10.0, "b"), (30.0, 5.0, "a"),
               (50.0, 1.0, "c")]
    total, gaps = run.busy(kernels)
    assert total == pytest.approx((15 + 5 + 1) / 1e6)
    assert gaps == [(15.0, 30.0), (35.0, 50.0)]
    prof = {"kernels": kernels,
            "host": [(0.0, 60.0, "simbench.decode"),
                     (14.0, 20.0, "cudaStreamSynchronize"),
                     (36.0, 10.0, "aten::copy_")]}
    b = run.breakdown(prof)
    assert b["device_ops"][0] == ["a", pytest.approx(15e-6)]
    assert b["idle_gaps"][0][0] == "simbench.decode: cudaStreamSynchronize"
    assert b["idle_gaps"][1][0] == "simbench.decode: aten::copy_"
    assert b["idle_gaps"][0][1] == pytest.approx(15e-6)


def test_batch_order_runs_the_pool_in_seeded_passes():
    import itertools

    from simbench.harness import batch_order

    a = list(itertools.islice(batch_order(2 ** 31 + 3, 10), 35))
    for p in range(3):
        assert sorted(a[10 * p:10 * p + 10]) == list(range(10))
    assert a[:10] != a[10:20]
    assert list(itertools.islice(batch_order(2 ** 31 + 3, 10), 35)) == a
    assert list(itertools.islice(batch_order(7, 10), 35)) != a


@pytest.mark.parametrize("agree,batches", [(None, 5), (lambda n, e: 6, 10)])
def test_window_ends_on_a_whole_pass(agree, batches):
    """A window past its seconds still ends on a pass's end; a sharded
    run's agreed count is rounded up to whole passes."""
    import torch

    from simbench import harness

    rec = harness.Recorder(1, 4)
    win = harness.window(lambda b: torch.tensor([4, 0, 0, 0, 4, 1]), rec,
                         0.0, harness.batch_order(3, 5), "cpu", agree=agree,
                         whole=5)
    assert len(win["walls"]) == batches

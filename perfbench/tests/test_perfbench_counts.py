"""The operation and byte counts of the per-layer metrics against cases
worked by hand, and the readers on a made-up traced window."""

import pytest

from perfbench.harness import manifest, trace

M = {name: manifest.load_module(manifest.BENCH / "metrics" / f"{name}.py")
     for name in ("train_mfu", "eval_mfu", "rollout_roofline",
                  "kernels_per_iter.train", "host_syncs_per_iter.train",
                  "linalg_us_per_iter.train", "elementwise_us_per_iter.train",
                  "device_idle.train", "rollout_us_per_eval",
                  "prep_us_per_eval", "device_idle.eval", "eval_device_ms",
                  "evals_per_s.host", "rollout_us_per_eval.card",
                  "rollout_roofline.card", "prep_us_per_eval.card",
                  "eval_mfu.card")}
H100 = "NVIDIA H100 80GB HBM3"


def test_c4_flops_ballbeam():
    # 4·M²·N = 2e7, 4·M·N = 2e5, 3·Din·M·N = 7.5e5, 3·Din·M² = 1.5e5,
    # 4·M³/3 = 1.3333e6, 2·M² = 2e4: 22,453,333.3 a dim, ×3·D = 12.
    assert M["train_mfu"].c4_flops_per_iter(500, 4, 100, 5) == \
        pytest.approx(2.6944e8, rel=1e-12)


def test_rollout_work_s10_m100():
    # per step and row: 4·100·22 + 4·(4·5050) + 3·400 + 3·400 + 32 = 92,032
    ops, nbytes = M["rollout_roofline"].work(10, 500, 4, 100, 5, 1, 1, 4)
    assert ops == 10 * 500 * 92032
    # in: 10·4 starts + (2000 + 20 + 4 + 40400 + 400 + 4) params + 500
    # controls; out: 2·10·500·4
    assert nbytes == (40 + 42828 + 500 + 40000) * 4


def test_prep_flops_by_hand():
    # n=2, d=1, m=1, din=1: 3 + 4/3 + 6 + 8 + 4 + 4
    assert M["eval_mfu"].prep_flops(2, 1, 1, 1) == pytest.approx(26 + 1 / 3)


def _window(kind, units, wall_us, kernels, host=(), work=None, timed=None):
    """A traced window; ``timed`` (units, seconds, durations) its untraced
    one, by default twice as many units over twice the time."""
    w = trace.Window(kind=kind, units=units, wall_us=wall_us, start_us=0.0,
                     kernels=list(kernels), host=list(host),
                     work=work or {}, device_name=H100)
    w.timed(*(timed or (2 * units, 2 * wall_us * 1e-6, [])))
    return w


def test_train_readers():
    work = {"n": [500, 500], "m": 100, "d": 4, "din": 5}
    w = _window("train", 10, 1000.0,
                [("potrf_kernel", 0, 100), ("ampere_sgemm", 100, 300),
                 ("elementwise_add", 300, 600), ("elementwise_mul", 650, 700)],
                [("cudaStreamSynchronize", 700, 1000)], work)
    assert M["kernels_per_iter.train"].read(w) == 0.4
    assert M["host_syncs_per_iter.train"].read(w) == 0.1
    assert M["linalg_us_per_iter.train"].read(w) == 30.0
    assert M["elementwise_us_per_iter.train"].read(w) == 35.0
    assert M["device_idle.train"].read(w) == pytest.approx(35.0)
    flops = 2 * 2.6944e8 * 10 / 1e-3
    assert M["train_mfu"].read(w) == pytest.approx(100 * flops / 67e12)
    for name in ("rollout_us_per_eval", "prep_us_per_eval",
                 "device_idle.eval", "eval_mfu", "rollout_roofline",
                 "eval_device_ms", "evals_per_s.host", "eval_mfu.card"):
        assert M[name].read(w) is None


def test_eval_readers():
    work = {"n": [500], "m": 100, "d": 4, "din": 5, "cu": 1, "itemsize": 4,
            "launches": [{"rows": 10, "steps": 500, "sets": 1}]}
    w = _window("eval", 2, 10_000.0,
                [("void rollout_kernel<float>(...)", 0, 3000),
                 ("potrf", 3000, 4000)], work=work)
    assert M["rollout_us_per_eval"].read(w) == 1500.0
    assert M["prep_us_per_eval"].read(w) == 500.0
    bound_s = 10 * 500 * 92032 / 67e12
    assert M["rollout_roofline"].bound(w)[1] == "operations"
    assert M["rollout_roofline"].read(w) == pytest.approx(
        100 * bound_s * 2 / 3e-3)
    assert M["device_idle.eval"].read(w) == pytest.approx(60.0)
    assert M["kernels_per_iter.train"].read(w) is None
    # the card busy 4 ms over 2 evaluations; 4 untraced in 20 ms
    assert M["eval_device_ms"].read(w) == pytest.approx(2.0)
    assert M["evals_per_s.host"].read(w) == pytest.approx(200.0)
    for name in ("rollout_us_per_eval", "rollout_roofline",
                 "prep_us_per_eval"):
        assert M[name + ".card"].read(w) == M[name].read(w)
    flops = M["eval_mfu"].flops(work)
    assert flops == pytest.approx(M["eval_mfu"].prep_flops(500, 4, 100, 5)
                                  + 10 * 500 * 92032)
    assert M["eval_mfu.card"].read(w) == pytest.approx(
        100 * flops / 2e-3 / 67e12)
    # no rollout kernel in the window: the readers find nothing
    empty = _window("eval", 2, 10_000.0, [("potrf", 0, 10)], work=work)
    assert M["rollout_roofline"].read(empty) is None
    assert M["rollout_us_per_eval"].read(empty) is None


def test_host_clock_readings_come_from_the_untraced_window():
    # traced: 10 iterations in 1 ms, the card busy 0.5 ms; untraced: 40
    # iterations in 2.5 ms, so 0.5/10 × 40 / 2.5 = 80% busy
    work = {"n": [500], "m": 100, "d": 4, "din": 5}
    w = _window("train", 10, 1000.0, [("elementwise_add", 0, 500)],
                work=work, timed=(40, 2.5e-3, [1e-3] * 30))
    assert M["device_idle.train"].read(w) == pytest.approx(20.0)
    assert M["train_mfu"].read(w) == pytest.approx(
        100 * 2.6944e8 * 40 / 2.5e-3 / 67e12)
    e = _window("eval", 2, 10_000.0, [("potrf", 0, 1000)],
                work={"n": [500], "m": 100, "d": 4, "din": 5, "cu": 1,
                      "itemsize": 4, "launches": []},
                timed=(25, 1.0, [0.04] * 20 + [0.1] * 5))
    assert M["device_idle.eval"].read(e) == pytest.approx(
        100 * (1 - 500e-6 * 25 / 1.0))
    host = manifest.load_module(manifest.BENCH / "metrics"
                                / "eval_ms_p95.host.py")
    assert host.read(e) == pytest.approx(100.0)   # the 23rd of 25


def test_unknown_card_reads_no_share():
    w = _window("train", 1, 1.0, [("k", 0, 1)],
                work={"n": [1], "m": 1, "d": 1, "din": 1})
    w.device_name = "cpu"
    assert M["train_mfu"].read(w) is None


def test_breakdown_gaps_by_host_op():
    w = _window("train", 1, 100.0, [("a", 0, 10), ("b", 40, 50)],
                [("outer", 0, 100), ("cudaStreamSynchronize", 60, 90)])
    b = trace.breakdown(w)
    assert [n for n, _ in b["device_ops"]] == ["a", "b"]
    assert [s for _, s in b["device_ops"]] == pytest.approx([1e-5, 1e-5])
    gaps = dict(b["idle_gaps"])
    assert gaps["outer"] == pytest.approx(30e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(50e-6)

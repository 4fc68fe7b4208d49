"""The readers of the port's spans on made-up traced windows: the card's
idle time split among an evaluation's stages and scaled to the untraced
window, the replay loop's own host time, the graph builds; and no reading
where the program opened no span."""

import pytest

from perfbench.harness import manifest, trace

NAMES = ("prep_idle_us_per_eval", "moments_idle_us_per_eval",
         "unspanned_idle_us_per_eval", "prep_idle_us_per_eval.host",
         "moments_idle_us_per_eval.host", "unspanned_idle_us_per_eval.host",
         "replay_host_us_per_iter.train", "graph_builds_per_kiter.train")
M = {name: manifest.load_module(manifest.BENCH / "metrics" / f"{name}.py")
     for name in NAMES}
STAGES = M["prep_idle_us_per_eval"]


def _window(kind, units, kernels, host, timed_units, timed_us):
    w = trace.Window(kind=kind, units=units, wall_us=1000.0, start_us=0.0,
                     kernels=list(kernels), host=list(host), work={},
                     device_name="NVIDIA H100 80GB HBM3")
    w.timed(timed_units, timed_us * 1e-6, [])
    return w


# Two evaluations in 1000 µs; the card busy 100-200 and 500-600, so idle
# 0-100, 200-500 and 600-1000 (800 µs).  The second evaluation's launch
# lies inside its preparation, whose thinning overlaps it: the launch owns
# that stretch.  By stage: rollout 200-250 and 650-700 (100), moments
# 250-450 and 700-900 (400), preparation 0-100 and 600-650 (150), and
# 450-500 and 900-1000 in no stage (150).
KERNELS = [("potrf", 100, 200), ("rollout_kernel", 500, 600)]
EVAL_HOST = [
    ("ffvd::eval", 0, 450), ("ffvd::eval.prep", 0, 150),
    ("aten::mm", 10, 20), ("ffvd::eval.rollout", 150, 250),
    ("ffvd::eval.moments", 250, 450),
    ("ffvd::eval", 500, 950), ("ffvd::eval.prep", 500, 700),
    ("ffvd::eval.thin", 520, 680), ("ffvd::eval.rollout", 650, 700),
    ("ffvd::eval.moments", 700, 900)]


def test_the_stages_split_the_traced_idle_time():
    w = _window("eval", 2, KERNELS, EVAL_HOST, 4, 2000.0)
    assert STAGES.split(w) == {"rollout": 100.0, "moments": 400.0,
                               "prep": 150.0, "unspanned": 150.0}
    # the untraced window: 500 µs an evaluation, 100 of them busy, so the
    # 400 idle µs of the trace's evaluations keep their size
    assert M["prep_idle_us_per_eval"].read(w) == 75.0
    assert M["moments_idle_us_per_eval"].read(w) == 200.0
    assert M["unspanned_idle_us_per_eval"].read(w) == 75.0
    for name in ("prep", "moments", "unspanned"):
        assert M[f"{name}_idle_us_per_eval.host"].read(w) == \
            M[f"{name}_idle_us_per_eval"].read(w)


@pytest.mark.parametrize("timed_us,untraced", [
    (1200.0, 200.0),        # 300 µs an evaluation: the shares of 200
    (200.0, 0.0)])          # faster than the card's busy time: floored
def test_the_split_is_scaled_to_the_untraced_idle_time(timed_us, untraced):
    w = _window("eval", 2, KERNELS, EVAL_HOST, 4, timed_us)
    parts = {k: STAGES.idle_us_per_eval(w, k)
             for k in ("rollout", "moments", "prep", "unspanned")}
    assert parts == {"rollout": untraced / 8, "moments": untraced / 2,
                     "prep": untraced * 3 / 16,
                     "unspanned": untraced * 3 / 16}
    assert sum(parts.values()) == pytest.approx(untraced)


def test_replay_host_time_leaves_out_runtime_calls():
    host = [("ffvd::train.run", 0, 1000), ("ffvd::train.replay", 0, 900),
            ("aten::copy_", 50, 80), ("cudaGraphLaunch", 100, 300),
            ("cudaGraphLaunch", 250, 400), ("Command Buffer Full", 500, 600),
            ("cudaStreamSynchronize", 950, 990)]
    w = _window("train", 10, [("k", 0, 1000)], host, 20, 2000.0)
    # 900 µs of loop less 300 of launches and 100 of the profiler's buffer
    assert M["replay_host_us_per_iter.train"].read(w) == 50.0
    assert M["graph_builds_per_kiter.train"].read(w) == 0.0


def test_graph_builds_count_warmups_and_captures():
    host = [("ffvd::train.run", 0, 1000), ("ffvd::graph.warmup", 0, 100),
            ("ffvd::graph.warmup", 100, 200),
            ("ffvd::graph.capture", 200, 300),
            ("ffvd::train.replay", 300, 900)]
    w = _window("train", 3000, [("k", 0, 1000)], host, 6000, 2000.0)
    assert M["graph_builds_per_kiter.train"].read(w) == 1.0


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_no_reading_without_the_spans(kind):
    host = [("aten::mm", 10, 20), ("train.chunk", 0, 900),
            ("eval.call", 0, 900), ("cudaGraphLaunch", 100, 300)]
    w = _window(kind, 2, KERNELS, host, 4, 2000.0)
    assert all(M[n].read(w) is None for n in NAMES)
    # nor in a window of the other kind
    other = _window("train" if kind == "eval" else "eval", 2, KERNELS,
                    EVAL_HOST + [("ffvd::train.run", 0, 1000),
                                 ("ffvd::train.replay", 0, 900)], 4, 2000.0)
    wrong = [n for n in NAMES if n.endswith(".train") == (kind == "train")]
    assert all(M[n].read(other) is None for n in wrong)

"""The port's training tooling (``ffvd_tpu_torch/utils/``): metrics,
checkpoints, timing and profiling, held against the JAX package's
``ffvd_tpu/utils`` where the two compute the same thing.

- ``split_rhat`` against JAX at rtol 1e-12, and the five cases of
  ``tests/test_eval_and_data.py:281-298``; ``elbo_report`` against JAX at
  rtol 1e-12 (fp64).
- ``MetricsLogger``'s rate and JSONL sink; ``TensorBoardSink``'s tags equal
  the JAX sink's; ``FFVDModel.fit`` and the CLI write summaries.
- Checkpoints: a round trip, ``max_to_keep``, a resume that is bit-exact
  (``torch.equal``) against an uninterrupted run for C4, for C5 with its
  generator and for stacked chains, and a refused format.
- ``hard_sync``, ``timed_ms``, ``in_program_ms`` and ``trace`` on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init
from ffvd_tpu.utils import metrics as jmetrics

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.cli import main as cli_main
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import SSMData, init_params_from_warmstart
from ffvd_tpu_torch.parallel import MultiChainTrainer
from ffvd_tpu_torch.utils import checkpoint as ck
from ffvd_tpu_torch.utils import metrics, profiling, timing

torch.set_num_threads(2)


# -- metrics ------------------------------------------------------------------

def test_split_rhat_matches_jax_and_its_cases():
    rng = np.random.RandomState(0)
    for trace in (rng.randn(300, 4), rng.randn(301, 3) + np.arange(3),
                  rng.randn(50)):
        np.testing.assert_allclose(metrics.split_rhat(trace),
                                   jmetrics.split_rhat(trace), rtol=1e-12)
    mixed = rng.randn(2000, 4)
    assert abs(metrics.split_rhat(mixed) - 1.0) < 0.02
    assert metrics.split_rhat(mixed + np.array([0.0, 0.0, 0.0, 5.0])) > 1.5
    drifting = rng.randn(2000) + np.linspace(0, 4, 2000)
    assert metrics.split_rhat(drifting) > 1.1
    assert metrics.split_rhat(np.ones((100, 3))) == 1.0
    assert np.isnan(metrics.split_rhat(np.ones((2, 3))))
    # MultiChainTrainer.rhat reads the tail of a (T, C) tensor trace
    t = torch.tensor(mixed)
    assert MultiChainTrainer.rhat(t) == metrics.split_rhat(mixed[1000:])


def test_elbo_report_matches_jax():
    ds = create_dataset("ballbeam")
    ws = load_warmstart("ballbeam")
    rep = metrics.elbo_report(
        init_params_from_warmstart(ws),
        SSMData(y=torch.as_tensor(ds.y_train),
                control=torch.as_tensor(ds.control)),
        u_collapse=True, iteration=7)
    jrep = jax.jit(lambda p, d: jmetrics.elbo_terms(p, d, u_collapse=True))(
        j_init(j_load_warmstart("ballbeam")),
        JSSMData(y=jnp.asarray(ds.y_train), control=jnp.asarray(ds.control)))
    assert rep["iter"] == 7
    assert set(rep) == {"iter", "marginal_ll"} | {
        f"ll_{k}" for k in jrep if k != "nll"}
    np.testing.assert_allclose(rep["marginal_ll"], -float(jrep["nll"]),
                               rtol=1e-12)
    # atol: the trace term (3e-4) is a difference of O(1) sums, and the
    # two summation orders leave it 4e-16 apart
    for k, v in jrep.items():
        if k != "nll":
            np.testing.assert_allclose(rep[f"ll_{k}"], -float(v),
                                       rtol=1e-12, atol=1e-14, err_msg=k)


def test_metrics_logger_rate_and_jsonl(tmp_path, monkeypatch, capsys):
    clock = iter([100.0, 102.0, 103.0, 107.0])
    monkeypatch.setattr(metrics.time, "time", lambda: next(clock))
    log = metrics.MetricsLogger(str(tmp_path / "sub" / "m.jsonl"),
                                print_every=10)
    log.log({"iter": 10, "nll": -2.5})          # 10 iterations in 2 s
    log.log({"iter": 10, "rmse": 0.1})          # no advance: no rate
    log.log({"iter": 30, "nll": -3.0})          # 20 in 5 s
    log.close()
    assert log.history[0]["iters_per_sec"] == 5.0
    assert "iters_per_sec" not in log.history[1]
    assert log.history[2]["iters_per_sec"] == 4.0
    lines = [json.loads(l) for l in
             (tmp_path / "sub" / "m.jsonl").read_text().splitlines()]
    assert lines == log.history
    assert "METRIC iter=30 nll=-3.0000" in capsys.readouterr().out


class _Recorder:
    """A SummaryWriter stand-in that records (kind, tag, step)."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, step))

    def add_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, step))

    def close(self):
        pass


def test_tensorboard_sink_tags_equal_jax(tmp_path):
    sink = metrics.TensorBoardSink(str(tmp_path / "port"))
    sink.close()
    assert list((tmp_path / "port").glob("events.out.tfevents*"))
    sink._w = _Recorder()
    sink.write(init_params_from_warmstart(load_warmstart("ballbeam")), -2.4, 3)
    jsink = jmetrics.TensorBoardSink(str(tmp_path / "jax"))
    jsink.close()
    jsink._w = _Recorder()
    jsink.write(j_init(j_load_warmstart("ballbeam")), -2.4, 3)
    assert sink._w.calls == jsink._w.calls
    assert ("scalar", "marginal-ll", 3) in sink._w.calls
    assert ("histogram", "x3-histogram", 3) in sink._w.calls


def test_fit_and_cli_write_tensorboard_summaries(tmp_path, monkeypatch):
    made = []

    class Sink(metrics.TensorBoardSink):
        def __init__(self, logdir):
            super().__init__(logdir)
            made.append(self)
            self._w.close()
            self._w = _Recorder()

    monkeypatch.setattr(metrics, "TensorBoardSink", Sink)
    m = FFVDModel(FFVDConfig(dataset="ballbeam", case=4), device="cpu")
    m.fit(4, chunk_size=2, tensorboard_dir=str(tmp_path / "fit"))
    steps = sorted({s for k, t, s in made[0]._w.calls if t == "marginal-ll"})
    assert steps == [2, 4]
    out = cli_main(["--file_index", "5", "--case_val", "4", "--iterations",
                    "1", "--samples", "2", "--platform", "cpu",
                    "--results_dir", str(tmp_path / "r"),
                    "--tensorboard_dir", str(tmp_path / "cli")])
    assert np.isfinite(out["rmse"]) and len(made) == 2
    assert ("scalar", "kernel-0-log-variance", 2) in made[1]._w.calls
    assert list((tmp_path / "cli").glob("events.out.tfevents*"))


# -- checkpoints ----------------------------------------------------------------

def _trainer(case, **kw):
    cfg = FFVDConfig(dataset="ballbeam", case=case, **kw)
    ds = create_dataset("ballbeam")
    tr = Trainer(cfg, SSMData(y=torch.as_tensor(ds.y_train),
                              control=torch.as_tensor(ds.control)))
    return tr, init_params_from_warmstart(load_warmstart("ballbeam"))


def _assert_states_equal(a, b):
    for k, v in a.params.leaves().items():
        assert torch.equal(v, b.params.leaves()[k]), k
    for k, w in a.window.items():
        assert torch.equal(w, b.window[k]), k
    assert (a.step, a.window_count) == (b.step, b.window_count)
    if a.sghmc is not None:
        for f in ("xi", "g", "g2", "p"):
            for k, v in getattr(a.sghmc, f).items():
                assert torch.equal(v, getattr(b.sghmc, f)[k]), f"{f}.{k}"


@pytest.mark.parametrize("case", [4, 5])
def test_resume_is_bit_exact(case, tmp_path):
    tr, p0 = _trainer(case, window_size=3)
    gen = lambda: torch.Generator().manual_seed(2)
    full, trace = tr.run(tr.init_state(p0), 6, generator=gen())

    mgr = ck.CheckpointManager(tmp_path, max_to_keep=2)
    g = gen()
    _, first = ck.run_with_checkpoints(tr, tr.init_state(p0), 3, mgr,
                                       every=1, generator=g)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    g2 = torch.Generator().manual_seed(99)       # another stream, restored
    resumed = mgr.restore(tr.init_state(p0), generator=g2)
    assert resumed.step == 3
    resumed, rest = ck.run_with_checkpoints(tr, resumed, 6, mgr, every=2,
                                            generator=g2)
    assert torch.equal(torch.cat([first, rest]), trace)
    _assert_states_equal(resumed, full)
    # Adam's moments came back too
    sa, sb = resumed.adam.state_dict(), full.adam.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_stacked_chain_state_resumes_bit_exact(tmp_path):
    tr, p0 = _trainer(2, window_size=2)
    mct = MultiChainTrainer(tr.cfg, tr.data, 2)
    stacked = mct.stack_params(p0, torch.Generator().manual_seed(0))
    full, trace = mct.run(mct.init_state(stacked), 3,
                          generator=torch.Generator().manual_seed(1))
    mgr = ck.CheckpointManager(tmp_path)
    g = torch.Generator().manual_seed(1)
    _, a = ck.run_with_checkpoints(mct, mct.init_state(stacked), 2, mgr,
                                   every=2, generator=g)
    g2 = torch.Generator()
    state = mgr.restore(mct.init_state(stacked), generator=g2)
    state, b = ck.run_with_checkpoints(mct, state, 3, mgr, generator=g2)
    assert torch.equal(torch.cat([a, b]), trace)
    _assert_states_equal(state, full)


def test_restore_refuses_another_format(tmp_path, monkeypatch):
    tr, p0 = _trainer(4)
    mgr = ck.CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(tr.init_state(p0))
    monkeypatch.setattr(ck, "CHECKPOINT_FORMAT", ck.CHECKPOINT_FORMAT + 1)
    mgr.save(1, tr.init_state(p0))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="format"):
        mgr.restore(tr.init_state(p0))


# -- timing and profiling -----------------------------------------------------

def test_timing_and_profiling_on_the_cpu(tmp_path):
    a = torch.randn(64, 64, dtype=torch.float64)
    assert timing.hard_sync(a) is a and timing.hard_sync() is None
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    ms = timing.timed_ms(fn, a, n=5, warmup=2)
    assert ms > 0 and len(calls) == 7
    calls.clear()
    per = timing.in_program_ms(fn, a, k=4, n=2)
    assert np.isfinite(per) and len(calls) == 1 + 2 * (4 + 8)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        fn(a)
    assert (tmp_path / "tr" / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())

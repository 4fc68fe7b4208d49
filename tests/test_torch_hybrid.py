"""Port parity: the hybrid precision schedule and the entry points of the
precision modes (``api.FFVDModel``, the CLI), against the JAX package.

- The schedule: with a spy on both packages' ``Trainer.run`` (JAX's
  records and returns zeros, so no JAX ds64 program is ever compiled), the
  sequences of (trainer precision, iterations) of ``fit`` are equal for
  several (n, ``hybrid_tail_iters``, ``chunk_size``, ``eval_every``), over
  two ``fit`` calls (per-call semantics, ``ffvd_tpu/api.py:149-153``).
- The native part of a hybrid ``fit`` is, bit for bit, a native model's
  trace; the tail continues from that state on a ds64 Trainer, Adam's
  moments carried.
- ``eval_trainer`` is the ds64 trainer exactly when the case is collapsed,
  as in JAX; a C1 hybrid config still rolls out with ``ds_precal``'s
  factors (``ffvd_tpu/eval/rollout.py:128``), a C4 one with
  ``ds_collapsed_u_posterior``'s q(U).
- ballbeam C4 and C5 train and evaluate under ds64 and hybrid (fp64 CPU);
  the CLI runs ``--collapse_precision``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.api import FFVDModel as JFFVDModel
from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.inference.trainer import Trainer as JTrainer

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.cli import main as cli_main
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.eval import rollout as er
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.ds_collapse import (ds_collapsed_u_posterior,
                                              ds_precal)
from ffvd_tpu_torch.model.elbo import gp_inputs
from ffvd_tpu_torch.ops import rollout as ro

torch.set_num_threads(2)


@pytest.mark.parametrize("n,tail,chunk,every", [
    (10, 4, 3, None), (10, 4, 100, 5), (6, 20, 4, None), (9, 0, 4, 3),
    (11, 3, 2, 4)])
def test_hybrid_schedule_matches_jax(monkeypatch, n, tail, chunk, every):
    kw = dict(dataset="ballbeam", case=4, collapse_precision="hybrid",
              hybrid_tail_iters=tail)
    jcalls, calls = [], []

    def jrun(self, state, m, key, chunk_size=500, **_):
        jcalls.append((self.train_precision, m))
        return state, jnp.zeros((m,))
    monkeypatch.setattr(JTrainer, "run", jrun)
    monkeypatch.setattr(JFFVDModel, "evaluate_quick",
                        lambda self, *a, **k: {"rmse": 0.0, "nll": 0.0})
    jm = JFFVDModel(JConfig(**kw))
    orig = Trainer.run

    def run(self, state, m, **k):
        calls.append((self.train_precision, m))
        return orig(self, state, m, **k)
    monkeypatch.setattr(Trainer, "run", run)
    tm = FFVDModel(FFVDConfig(**kw), device="cpu")
    for _ in range(2):
        jm.fit(n, chunk_size=chunk, eval_every=every)
        tm.fit(n, chunk_size=chunk, eval_every=every)
    assert calls == jcalls
    assert sum(m for p, m in calls if p == "ds64") == 2 * min(tail, n)
    assert tm.nll_trace.shape == (2 * n,)
    assert len(tm.rmse_seq) == (0 if every is None else 2 * -(-n // every))


def test_hybrid_native_part_is_native_and_tail_continues():
    kw = dict(dataset="ballbeam", case=4)
    h = FFVDModel(FFVDConfig(**kw, collapse_precision="hybrid",
                             hybrid_tail_iters=3), device="cpu")
    h.fit(8, chunk_size=4)
    nat = FFVDModel(FFVDConfig(**kw), device="cpu").fit(5, chunk_size=4)
    assert torch.equal(h.nll_trace[:5], nat.nll_trace)
    tail = Trainer(FFVDConfig(**kw, collapse_precision="ds64"), nat.data)
    _, t = tail.run(nat.state, 3, generator=nat.train_generator)
    assert torch.equal(h.nll_trace[5:], t)
    for k, v in h.params.leaves().items():
        assert torch.equal(v, nat.params.leaves()[k]), k
    # one Adam across the switch: its step count and moments carried on
    assert h.state.step == 8
    assert all(s["step"] == 8 for s in h.state.adam.state.values())
    native_tail = FFVDModel(FFVDConfig(**kw), device="cpu").fit(8)
    assert not torch.equal(native_tail.nll_trace[5:], h.nll_trace[5:])


@pytest.mark.parametrize("case", range(1, 8))
def test_eval_trainer_is_ds64_exactly_when_collapsed(case):
    kw = dict(dataset="ballbeam", case=case, collapse_precision="hybrid")
    tm = FFVDModel(FFVDConfig(**kw), device="cpu")
    jm = JFFVDModel(JConfig(**kw))
    collapsed = tm.cfg.case_config.u_collapse
    assert tm.hybrid is jm.hybrid is collapsed
    assert tm.trainer.train_precision == "native"
    assert (tm.eval_trainer.train_precision
            == jm.eval_trainer.train_precision
            == ("ds64" if collapsed else "native"))
    assert (tm.eval_trainer is tm._tail_trainer()) is collapsed
    assert tm.eval_trainer.cfg.collapse_precision == (
        "ds64" if collapsed else "hybrid")


def _spy_rollout(monkeypatch):
    seen = {}

    def rollout(*a, **k):
        seen.update(lm_inv=a[2], u_val=a[3], q_sqrt=a[4])
        return ro.rollout(*a, **k)
    monkeypatch.setattr(er, "rollout_ops", types.SimpleNamespace(
        rollout=rollout, rollout_batched=ro.rollout_batched))
    return seen


@pytest.mark.parametrize("case", [1, 4])
def test_hybrid_rollout_takes_the_fp64_segment(monkeypatch, case):
    m = FFVDModel(FFVDConfig(dataset="ballbeam", case=case,
                             collapse_precision="hybrid",
                             hybrid_tail_iters=1), device="cpu").fit(2)
    seen = _spy_rollout(monkeypatch)
    res = m.evaluate(num_samples=2)
    assert np.isfinite(res["rmse"]) and np.isfinite(res["nll"])
    p, cfg = m.params, m.cfg
    pre = ds_precal(cfg.kernel_type, p.kernel, p.z, cfg.jitter)
    assert seen["lm_inv"].dtype == torch.float64
    assert torch.equal(seen["lm_inv"], pre.lm_inv.double())
    native = er.kernel_precal(cfg.kernel_type, p.kernel, p.z, cfg.jitter)
    assert not torch.equal(seen["lm_inv"], native.lm_inv)
    if case == 1:
        assert seen["q_sqrt"] is None and seen["u_val"] is p.u
        return
    u, qs = ds_collapsed_u_posterior(
        cfg.kernel_type, p.kernel, p.z, p.x,
        gp_inputs(p, m.data, jitter=cfg.jitter), p.log_q)
    assert torch.equal(seen["u_val"], u.double())
    assert torch.equal(seen["q_sqrt"], qs.double())


@pytest.mark.parametrize("case,precision", [
    (4, "ds64"), (4, "hybrid"), (5, "ds64"), (5, "hybrid")])
def test_models_train_and_evaluate(monkeypatch, case, precision):
    cfg = FFVDConfig(dataset="ballbeam", case=case,
                     collapse_precision=precision, hybrid_tail_iters=2,
                     posterior_sample_spacing=2)
    m = FFVDModel(cfg, device="cpu").fit(3)
    thinned = []
    orig = Trainer.subset_grads

    def spy(self, *a, **k):
        thinned.append(self.train_precision)
        return orig(self, *a, **k)
    monkeypatch.setattr(Trainer, "subset_grads", spy)
    res = m.evaluate(num_samples=2)
    assert bool(torch.isfinite(m.nll_trace).all())
    assert np.isfinite(res["rmse"]) and np.isfinite(res["nll"])
    # C5 thins its chain on the ds64 objective, hybrid or not
    assert thinned == (["ds64"] * 4 if case == 5 else [])


def test_cli_runs_precision_modes(tmp_path, capsys):
    for p in ("ds64", "hybrid"):
        out = cli_main(["--file_index", "5", "--case_val", "4",
                        "--iterations", "2", "--platform", "cpu",
                        "--collapse_precision", p, "--hybrid_tail_iters", "2",
                        "--ds64_refine", "2",
                        "--results_dir", str(tmp_path / p)])
        assert np.isfinite(out["rmse"]) and np.isfinite(out["final_elbo"])
        assert len(list((tmp_path / p / "ballbeam").glob("C4VFE_*"))) == 1
    assert "cpu fp64" in capsys.readouterr().out

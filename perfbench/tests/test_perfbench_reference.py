"""The plain reference against the port in float64 at small sizes: the
series, the warm starts, the grown inducing set, the rollout's random
numbers, the collapsed objective and its gradient, q(U), the rollout, and
whole runs of each cell on the CPU."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness import manifest, runner
from perfbench.reference import gpssm as ref

DATA = manifest.ROOT / "ffvd_tpu/data/vendored"
NAMES = ["actuator", "ballbeam", "drive", "dryer", "flutter", "gas_furnace"]
F64 = dict(dtype=torch.float64, device="cpu")


def _port_leaves(name, m=None, seed=0):
    from ffvd_tpu_torch.data import load_warmstart
    from ffvd_tpu_torch.model.params import (init_params_from_warmstart,
                                             params_to_numpy)
    from ffvd_tpu_torch.parallel.multidataset import _resize_inducing
    p = init_params_from_warmstart(load_warmstart(name), dtype=torch.float64)
    if m is not None and m != p.z.shape[0]:     # as stack_datasets does
        p = _resize_inducing(p, m, seed)
    return p, params_to_numpy(p)


@pytest.mark.parametrize("name", NAMES)
def test_series_and_warm_start(name):
    from ffvd_tpu_torch.data import create_dataset
    ds = create_dataset(name)
    ser = ref.load_series(DATA, name)
    for k in ("y_train", "y_test", "control"):
        np.testing.assert_array_equal(ser[k], getattr(ds, k))
    assert ser["y_train_std"] == ds.y_train_std
    _, port = _port_leaves(name)
    mine = ref.warm_start(DATA, name)
    for k in ref.LEAVES:
        np.testing.assert_array_equal(mine[k], port[k])


@pytest.mark.parametrize("m", [80, 100, 160])
def test_resize_inducing(m):
    _, port = _port_leaves("dryer", m, seed=123456789)
    mine = ref.resize_inducing(ref.warm_start(DATA, "dryer"), m, 123456789)
    for k in ("z", "u"):
        np.testing.assert_allclose(mine[k], port[k], rtol=0, atol=1e-15)


def test_philox_and_keys():
    from ffvd_tpu_torch.ops.rollout import draw_seed, philox_normals
    key = 2 ** 62 + 987654321
    np.testing.assert_allclose(
        ref.philox_normals(key, (3, 7, 4), torch.float64, "cpu", 5),
        philox_normals(key, (3, 7, 4), torch.float64, "cpu", 5),
        rtol=0, atol=0)
    g = torch.Generator().manual_seed(2 ** 40 + 3)
    assert ref.keys_of(2 ** 40 + 3, 3) == [draw_seed(g) for _ in range(3)]


def _ballbeam():
    from ffvd_tpu_torch.data import create_dataset
    ds = create_dataset("ballbeam")
    p, leaves = _port_leaves("ballbeam")
    y = torch.as_tensor(ds.y_train, **F64)
    ctrl = torch.as_tensor(ds.control, **F64)
    return p, ref.as_tensors(leaves, stored=torch.float64, **F64), y, ctrl


def test_objective_and_gradient():
    from ffvd_tpu_torch.model.elbo import negative_elbo
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    p, mine, y, ctrl = _ballbeam()
    leaves = {k: v.clone().requires_grad_(k != "u")
              for k, v in p.leaves().items()}
    nll = negative_elbo(GPSSMParams.from_leaves(leaves),
                        SSMData(y=y, control=ctrl))
    grads = torch.autograd.grad(nll, [leaves[k] for k in ref.TRAINED])
    got, mine_grad = ref.gradient(mine, y, ctrl)
    assert float(got) == pytest.approx(-2.410755, abs=1e-6)
    assert float(got) == pytest.approx(float(nll.detach()), rel=1e-13)
    for k, g in zip(ref.TRAINED, grads):
        np.testing.assert_allclose(mine_grad[k], g, rtol=1e-9,
                                   atol=1e-12 * float(g.abs().max()))


def test_q_u_and_rollout():
    from ffvd_tpu_torch.model.conditionals import (collapsed_u_posterior,
                                                   kernel_precal)
    from ffvd_tpu_torch.model.elbo import gp_inputs
    from ffvd_tpu_torch.model.params import SSMData
    from ffvd_tpu_torch.ops.rollout import philox_normals, rollout_reference
    p, mine, y, ctrl = _ballbeam()
    data = SSMData(y=y, control=ctrl)
    pre = kernel_precal("SquaredExponential", p.kernel, p.z)
    u, q_sqrt = collapsed_u_posterior("SquaredExponential", p.kernel, pre,
                                      p.z, p.x, gp_inputs(p, data), p.q)
    inp = ref.rollout_inputs(mine, ctrl, 500)
    np.testing.assert_allclose(inp["lm_inv"], pre.lm_inv, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(inp["u"], u, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(inp["q_sqrt"], q_sqrt, rtol=1e-7, atol=1e-9)
    noise = philox_normals(77, (3, 40, 4), torch.float64)
    xs, vs = rollout_reference(p.kernel, p.z, pre.lm_inv, u, q_sqrt, p.q,
                               p.x[-1], ctrl[500:540], 3, noise=noise)
    mx, mv = ref.rollout([mine], [inp], ctrl[500:540], noise[None])
    np.testing.assert_allclose(mx[0], xs, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(mv[0], vs, rtol=1e-8, atol=1e-12)


SIX = json.loads((manifest.ROOT / "perfbench/configs/six-ds-c4-m512.json")
                 .read_text())
SMALL = {"c4x8-train": {"chains": 2}, "c4x8-eval": {"chains": 2},
         "m512x6-train": {"datasets": ["gas_furnace", "drive"],
                          "model": {**SIX["model"], "num_inducing": 120}},
         "m512x6-eval": {"datasets": ["gas_furnace", "drive"],
                         "model": {**SIX["model"], "num_inducing": 120}}}
MIX = {"chunk_size": 2, "check_steps": 5, "stepwise_steps": 3,
       "setup_train_iters": 7, "checked_calls": 2, "trace_seconds": 0.5}


def small(cell, dtype="float64"):
    return {**SMALL[cell], "dtype": dtype, "mix": MIX}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_whole_run_in_float64(cell):
    r = runner.run_cell(cell, 2 ** 31 + 12345, 0.2, False, device="cpu",
                        overrides=small(cell))
    assert r["correct"], r["checks"]
    for name, row in r["checks"].items():
        assert row["value"] < 1e-9, (name, row)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    # the host-clock end-to-end metrics; on the CPU no card trace reads
    want = {m["name"] for m in manifest.cell(cell).end_to_end
            if not manifest.traced(m)}
    assert set(r["metrics"]) == want


def test_device_trace_metric_reads_a_traced_window(monkeypatch):
    """An end-to-end metric read from the card's trace makes an untraced
    run trace a window after the measured one, and is read from it."""
    seen = []
    real = runner.Run.window

    def window(self, seconds, traced):
        seen.append(traced)
        return real(self, seconds, traced)

    monkeypatch.setattr(runner.Run, "window", window)
    r = runner.run_cell("c4x8-eval", 2 ** 31 + 77, 0.2, False, device="cpu",
                        overrides=small("c4x8-eval"))
    assert seen == [False, True]
    assert r["correct"] and "busy_s" not in r["device"]
    assert set(r["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("cell", ["c4x8-train", "m512x6-eval"])
def test_whole_traced_run(cell):
    over = small(cell)
    over["mix"] = {**over["mix"], "trace_seconds": 0.5}
    r = runner.run_cell(cell, 2 ** 33 + 7, 0.2, True, device="cpu",
                        overrides=over)
    assert r["correct"], r["checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_moments_give_each_steps_gradient():
    from perfbench.harness import check
    rng = np.random.default_rng(5)
    grads = [{"a": rng.standard_normal(3)} for _ in range(4)]
    m, moments = np.zeros(3), []
    for g in grads:
        m = check.BETA1 * m + (1 - check.BETA1) * g["a"]
        moments.append({"a": m.copy()})
    for got, want in zip(check.grads_from_moments(moments), grads):
        np.testing.assert_allclose(got["a"], want["a"], rtol=1e-12)


def test_train_steps_snapshot():
    _, mine, y, ctrl = _ballbeam()
    nll, grads, snap, last = ref.train_steps(mine, y, ctrl, 3, 2, 2)
    nll2, grads2, _, two = ref.train_steps(mine, y, ctrl, 2)
    assert nll.shape == (3,) and len(grads) == 2 and len(grads2) == 1
    torch.testing.assert_close(nll[:2], nll2, rtol=0, atol=0)
    for k in ref.TRAINED:
        torch.testing.assert_close(snap[k], two[k], rtol=0, atol=0)
        torch.testing.assert_close(grads[0][k], grads2[0][k], rtol=0, atol=0)
        assert not torch.equal(last[k], two[k]) or k == "x"


def test_reference_trains_the_whole_set_up():
    """An evaluation cell's reference trains every set-up step itself and
    evaluates from its own leaves; the program's steps are read call by
    call."""
    cell = manifest.cell("m512x6-eval", small("m512x6-eval"))
    run = runner.Run(cell, 2 ** 34 + 1, "cpu")
    for _ in range(2):
        cs = next(run.call_seeds)
        run.sample.offer((cs, run.sut.evaluate(cs)))
    out = run.program_outputs()
    run.release()
    members = run.members()
    truth = runner.reference_outputs(cell, members, [cs for cs, _ in
                                                     out["calls"]],
                                     torch.float64, "cpu")
    assert out["steps"]["nll"].shape == truth["steps"]["nll"].shape == (7, 2)
    assert len(out["steps"]["grad"]) == len(truth["steps"]["grad"]) == 3
    numbers = runner.judge(cell, out, truth, members)
    assert max(numbers.values()) < 1e-9, numbers

"""The grouped rollout (``rollout_grouped``), on the CPU: G independent
posteriors in one call, each group of R rows with its own parameter set,
controls, number of steps and generator.

- Each group of the plain grouped rollout equals ``rollout_reference`` of
  its own set alone, bit for bit (fp64), with given noise and with each
  group's generator (the in-kernel Philox stream), and the padded tail past
  a group's steps is zero; three groups of 7, 5 and 2 steps, R=3.
- The input checks, and no kernel launch on CPU tensors.
- ``MultiDatasetTrainer.evaluate`` of C4 makes one grouped call and gives,
  bit for bit, the scores of ``collect_posterior``, ``predict_summary``
  and ``rmse_nll`` a dataset with the same generators; a sampler case (C5)
  and a LinearK config keep ``collect_posterior`` a dataset.

It imports nothing of JAX.
"""

import contextlib
import dataclasses

import pytest
import torch

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset
from ffvd_tpu_torch.eval import rollout as er
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.model.params import SSMData
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.ops.kernels import KernelParams
from ffvd_tpu_torch.parallel import MultiDatasetTrainer, stack_datasets
from ffvd_tpu_torch.parallel.sharding import member

torch.set_num_threads(2)

LENS = (7, 5, 2)                    # steps of each group
R, D, M, U = 3, 2, 6, 1
NAMES = ("drive", "gas_furnace")


def _groups(seed=0, with_q=True):
    """Three parameter sets stacked on a group axis, and each group's
    controls (T_g, U), all float64."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    uni = lambda *s: torch.rand(*s, generator=g, dtype=torch.float64)
    sets = []
    for _ in LENS:
        kp = KernelParams(torch.log(uni(D) + 0.2),
                          torch.log(uni(D, D + U) + 0.5))
        z = rnd(M, D + U)
        sets.append(dict(
            lv=kp.log_variance, ls=kp.log_lengthscales, z=z,
            lm_inv=kernel_precal("SquaredExponential", kp, z,
                                 jitter=1e-2).lm_inv,
            u_val=0.3 * rnd(M, D), q_sqrt=torch.triu(0.1 * rnd(D, M, M)),
            q=0.05 + 0.1 * uni(D), x0=0.5 * rnd(D)))
    st = {k: torch.stack([s[k] for s in sets]) for k in sets[0]}
    args = dict(kparams=KernelParams(st.pop("lv"), st.pop("ls")), **st)
    if not with_q:
        args["q_sqrt"] = None
    return args, [rnd(t, U) for t in LENS]


def _member(args, g):
    """Group g's set, as ``rollout`` takes it."""
    return {k: (KernelParams(v.log_variance[g], v.log_lengthscales[g])
                if k == "kparams" else None if v is None else v[g])
            for k, v in args.items()}


@pytest.mark.parametrize("noise_kind", ["given", "philox"])
@pytest.mark.parametrize("with_q", [True, False])
def test_each_group_is_its_own_rollout_bit_for_bit(noise_kind, with_q):
    args, controls = _groups(1, with_q)
    noise = [torch.randn(R, t, D, generator=torch.Generator().manual_seed(t),
                         dtype=torch.float64) for t in LENS]
    seeded = lambda: [torch.Generator().manual_seed(30 + g)
                      for g in range(len(LENS))]
    kw = ((lambda: dict(noise=noise)) if noise_kind == "given"
          else (lambda: dict(generators=seeded())))
    xs, vs = ro.rollout_grouped(**args, controls=controls, num_samples=R,
                                row_offset=4, **kw())
    assert xs.shape == vs.shape == (len(LENS), R, max(LENS), D)
    xr, vr = ro.rollout_reference_grouped(**args, controls=controls,
                                          num_samples=R, row_offset=4, **kw())
    assert torch.equal(xs, xr) and torch.equal(vs, vr)
    gens = seeded()
    for g, t in enumerate(LENS):
        one = dict(noise=noise[g]) if noise_kind == "given" else dict(
            generator=gens[g])
        x1, v1 = ro.rollout_reference(**_member(args, g),
                                      controls=controls[g], num_samples=R,
                                      row_offset=4, **one)
        assert torch.equal(xs[g, :, :t], x1) and torch.equal(vs[g, :, :t], v1)
        assert not xs[g, :, t:].any() and not vs[g, :, t:].any()
    # each group ran on its own set
    assert not torch.equal(xs[0, :, :2], xs[1, :, :2])


def test_cpu_grouped_rollout_launches_nothing():
    args, controls = _groups(2)
    before = (ro.rollout.launches, ro.rollout.grouped_launches)
    xs, _ = ro.rollout_grouped(**args, controls=controls, num_samples=R)
    assert (ro.rollout.launches, ro.rollout.grouped_launches) == before
    assert xs.shape == (3, R, 7, D) and torch.isfinite(xs).all()


def _bad(args, controls):
    """(name, arguments that a check refuses, the message it names)."""
    short = [c[:, :0] for c in controls]
    return [
        ("controls_count", dict(args, controls=controls[:2]), "controls"),
        ("control_width", dict(args, controls=controls[:2] + short[2:]),
         r"group 2: z has 3 input columns"),
        ("noise_shape", dict(args, controls=controls, noise=[
            torch.zeros(R, t + 1, D, dtype=torch.float64) for t in LENS]),
         r"group 0: noise has shape"),
        ("generators_count", dict(args, controls=controls,
                                  generators=[None]), "generators"),
        ("u_val_groups", dict(args, controls=controls,
                              u_val=args["u_val"][:2]), "u_val"),
        ("control_dtype", dict(args, controls=[c.float() for c in controls]),
         "controls is torch.float32"),
    ]


@pytest.mark.parametrize("case", [b[0] for b in _bad(*_groups())])
def test_grouped_rollout_checks_its_inputs(case):
    _, bad, match = next(b for b in _bad(*_groups()) if b[0] == case)
    with pytest.raises(ValueError, match=match):
        ro.rollout_grouped(**bad, num_samples=R)


def _stacked(case=4, **kw):
    data, params, lens = stack_datasets(NAMES, m=12)
    cfg = FFVDConfig(dataset=NAMES[0], case=case, num_inducing=12,
                     num_posterior_samples=2, **kw)
    mdt = MultiDatasetTrainer(cfg, data)
    return cfg, mdt, mdt.init_state(params), lens


@pytest.mark.parametrize("horizon", [30, 300])
def test_evaluate_is_each_datasets_collect_posterior(horizon):
    cfg, mdt, state, lens = _stacked()
    dss = [create_dataset(n) for n in NAMES]
    res = mdt.evaluate(state, dss, lens, horizon=horizon,
                       generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    gens = [torch.Generator().manual_seed(ro.draw_seed(g)) for _ in dss]
    with torch.no_grad():
        for i, (ds, n) in enumerate(zip(dss, lens)):
            p = member(state.params, i)
            p = dataclasses.replace(p, x=p.x[:n + 1])
            tr = Trainer(cfg, SSMData(y=torch.as_tensor(ds.y_train),
                                      control=torch.as_tensor(ds.control)))
            xs, vs, _ = er.collect_posterior(tr, tr.init_state(p), ds.n_test,
                                             generator=gens[i])
            py, pv, _ = er.predict_summary(p, xs, vs)
            rmse, nll = er.rmse_nll(torch.as_tensor(ds.y_test), py, pv,
                                    ds.y_train_std, horizon=horizon)
            assert res[ds.name] == {"rmse": float(rmse), "nll": float(nll)}


@pytest.mark.parametrize("kw,grouped", [
    (dict(case=4), True), (dict(case=5), False),
    (dict(case=4, kernel_type="LinearK"), False)],
    ids=["C4-grouped", "C5-per-dataset", "LinearK-per-dataset"])
def test_which_configs_take_the_grouped_call(monkeypatch, kw, grouped):
    calls = []
    real_grouped, real_collect = ro.rollout_grouped, er.collect_posterior
    monkeypatch.setattr(ro, "rollout_grouped", lambda *a, **k: calls.append(
        "grouped") or real_grouped(*a, **k))
    monkeypatch.setattr(er, "collect_posterior", lambda *a, **k: calls.append(
        "collect") or real_collect(*a, **k))
    _, mdt, state, lens = _stacked(**kw)
    with (pytest.warns(UserWarning) if mdt.has_sghmc
          else contextlib.nullcontext()):
        mdt.evaluate(state, [create_dataset(n) for n in NAMES], lens,
                     generator=torch.Generator().manual_seed(0),
                     thin_generator=torch.Generator().manual_seed(1),
                     horizon=12)
    assert calls == (["grouped"] if grouped else ["collect"] * len(NAMES))


"""The rollout kernel on the card against its plain version.

These tests need a CUDA device and ``nvcc``; elsewhere they skip.  They
import nothing of JAX, so on the card's machine (which has no JAX) they run
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Tolerances: fp64 rtol 1e-9, atol 1e-12 over all steps (summation order
only); fp32 rtol 1e-4, atol 1e-5 over the first 10 steps.  Beside the small
default shapes, the cases cover each branch of ``rollout_plan``: a cluster
of six CTAs (D=6), a CTA that owns two dims (D=9), resident factors at
M=200 in fp32 and global ones at M=320 in fp64; and the per-sample mode
(``rollout_batched``, a thinned SG-HMC posterior) on the resident and
global paths.  The torch paths of case C6 and of the linear kernel: one
fp64 particle-Gibbs sweep on the card equals the CPU's with the same
injected draws (identical resampling indices, x within rtol 1e-9), its
recursion and backtrack under ``set_sync_debug_mode("error")``; and the
LinearK rollout on the card equals the CPU's (rtol 1e-9) with no launch.
A ds64 C4 step (the collapsed segment in float64) equals the CPU's.  A
launch with a Philox ``row_offset`` gives the matching rows of a whole
launch, bit for bit, and a grouped launch (``rollout_grouped``) gives
each group's rows as the group's own launch does, bit for bit, on both
plans; a six-dataset ``evaluate()`` is one such launch.
"""

import pytest
import torch

from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.ops.kernels import KernelParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, dtype, d=3, m=37, u_dim=1, t_len=25, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    din = d + u_dim
    kp = KernelParams(torch.log(torch.rand(d, generator=g,
                                           dtype=torch.float64) + 0.2),
                      torch.log(torch.rand(d, din, generator=g,
                                           dtype=torch.float64) + 0.5))
    z = rnd(m, din)
    # a large jitter keeps Lm⁻¹ well conditioned, so fp32 rounding is not
    # amplified and the fp32 comparison measures the kernel, not the input
    pre = kernel_precal("SquaredExponential", kp, z, jitter=1e-2)
    q_sqrt = torch.triu(0.1 * rnd(d, m, m))
    args = [kp, z, pre.lm_inv, 0.3 * rnd(m, d), q_sqrt,
            0.05 + 0.1 * torch.rand(d, generator=g, dtype=torch.float64),
            0.5 * rnd(d), rnd(t_len, u_dim)]
    move = lambda t: t.to(device, dtype).contiguous()
    args = [KernelParams(move(kp.log_variance), move(kp.log_lengthscales))] \
        + [move(a) for a in args[1:]]
    return args


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("u_dim", [1, 0])
def test_kernel_matches_plain_version(cuda, dtype, with_q, u_dim):
    args = _inputs(cuda, dtype, u_dim=u_dim)
    if not with_q:
        args[4] = None
    noise = 0.1 * torch.randn(5, 25, 3, dtype=dtype, device=cuda)
    before = ro.rollout.launches
    xk, vk = ro.rollout(*args, 5, noise=noise)
    torch.cuda.synchronize()
    assert ro.rollout.launches == before + 1
    xr, vr = ro.rollout_reference(*args, 5, noise=noise)
    if dtype == torch.float64:
        tol, h = dict(rtol=1e-9, atol=1e-12), 25
    else:   # a free-running fp32 recursion drifts: hold the first 10 steps
        tol, h = dict(rtol=1e-4, atol=1e-5), 10
    torch.testing.assert_close(xk[:, :h], xr[:, :h], **tol)
    torch.testing.assert_close(vk[:, :h], vr[:, :h], **tol)


def _check_against_plain(cuda, dtype, d, m, t_len=12, samples=3):
    """Kernel against the plain version at the file's tolerances; returns
    the plan the wrapper launched with."""
    args = _inputs(cuda, dtype, d=d, m=m, t_len=t_len)
    noise = 0.1 * torch.randn(samples, t_len, d, dtype=dtype, device=cuda)
    xk, vk = ro.rollout(*args, samples, noise=noise)
    torch.cuda.synchronize()
    xr, vr = ro.rollout_reference(*args, samples, noise=noise)
    if dtype == torch.float64:
        tol, h = dict(rtol=1e-9, atol=1e-12), t_len
    else:
        tol, h = dict(rtol=1e-4, atol=1e-5), 10
    torch.testing.assert_close(xk[:, :h], xr[:, :h], **tol)
    torch.testing.assert_close(vk[:, :h], vr[:, :h], **tol)
    return ro.rollout.last_plan


def test_kernel_large_inducing_set(cuda):
    """M = 320 in fp64: the packed factors (2·51,360 values a dim) do not
    fit in shared memory, so the kernel reads them from global memory, and
    4·320 rows need more than 1024 threads, so each thread loops."""
    plan = _check_against_plain(cuda, torch.float64, d=4, m=320)
    assert not plan.resident and plan.cluster == 4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_six_latent_dims(cuda, dtype):
    """--x_dims 6: a cluster of six CTAs, one dim each."""
    plan = _check_against_plain(cuda, dtype, d=6, m=37, t_len=25)
    assert (plan.cluster, plan.dims_per_cta, plan.resident) == (6, 1, True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_nine_latent_dims(cuda, dtype):
    """D = 9 > 8, the cluster limit: CTA 0 owns dims 0 and 8."""
    plan = _check_against_plain(cuda, dtype, d=9, m=37, t_len=25)
    assert (plan.cluster, plan.dims_per_cta, plan.resident) == (8, 2, True)


def test_kernel_resident_at_200_inducing_points_fp32(cuda):
    """--num_inducing 200 in fp32: 160.8 KB of packed factors a CTA."""
    plan = _check_against_plain(cuda, torch.float32, d=4, m=200)
    assert plan.resident and plan.smem_bytes > 160_800


@pytest.mark.parametrize("dtype,m,resident", [
    (torch.float32, 100, True), (torch.float64, 100, True),
    (torch.float64, 200, False)])
def test_wrapper_launches_the_plan(cuda, dtype, m, resident):
    """The wrapper launches with the plan ``rollout_plan`` gives for the
    card's limits, and the resident flag is the expected one."""
    args = _inputs(cuda, dtype, d=4, m=m, t_len=3)
    ro.rollout(*args, 2, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    itemsize = 4 if dtype == torch.float32 else 8
    max_threads, optin = ro.kernel_limits(cuda, itemsize)
    assert optin >= 227 * 1024
    want = ro.rollout_plan(4, m, 5, itemsize, optin, max_threads)
    assert ro.rollout.last_plan == want
    assert want.resident is resident


def test_in_kernel_noise_is_the_plain_philox_stream(cuda):
    args = _inputs(cuda, torch.float64)
    xk, vk = ro.rollout(*args, 7, generator=torch.Generator().manual_seed(3))
    xr, vr = ro.rollout_reference(*args, 7,
                                  generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(xk, xr, rtol=1e-9, atol=1e-12)
    z = ro.ffvd_normals(42, 4096)
    torch.testing.assert_close(
        z, ro.philox_normals(42, (4096, 1, 1), torch.float32,
                             cuda).reshape(-1), rtol=1e-5, atol=1e-5)


def _batched_inputs(device, dtype, d, m, t_len, samples, seed=0):
    """Per-sample parameters: ``_inputs``' hypers, Z, U, q_sqrt, Q and x0
    perturbed from a seed for each sample, each with its own Lm⁻¹."""
    g = torch.Generator().manual_seed(seed + 100)
    per = []
    for i in range(samples):
        kp, z, _, u, q_sqrt, q, x0, ctrl = _inputs("cpu", torch.float64, d=d,
                                                   m=m, t_len=t_len,
                                                   seed=seed)
        jig = lambda t, s: t + s * torch.randn(t.shape, generator=g,
                                               dtype=torch.float64)
        kp = KernelParams(jig(kp.log_variance, 0.2),
                          jig(kp.log_lengthscales, 0.1))
        z = jig(z, 0.05)
        lm_inv = kernel_precal("SquaredExponential", kp, z,
                               jitter=1e-2).lm_inv
        per.append((kp, z, lm_inv, jig(u, 0.1), jig(q_sqrt, 0.01),
                    q * torch.exp(jig(torch.zeros_like(q), 0.3)),
                    jig(x0, 0.2)))
    move = lambda ts: torch.stack(ts).to(device, dtype).contiguous()
    kps = [p[0] for p in per]
    return dict(kparams=KernelParams(move([k.log_variance for k in kps]),
                                     move([k.log_lengthscales for k in kps])),
                z=move([p[1] for p in per]), lm_inv=move([p[2] for p in per]),
                u_val=move([p[3] for p in per]),
                q_sqrt=move([torch.triu(p[4]) for p in per]),
                q=move([p[5] for p in per]), x0=move([p[6] for p in per]),
                controls=ctrl.to(device, dtype).contiguous())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("d,m,resident", [(4, 37, True), (6, 37, True),
                                          (4, 320, False)])
def test_per_sample_kernel_matches_plain_version(cuda, dtype, with_q, d, m,
                                                 resident):
    """``rollout_batched``: one launch for S samples with their own
    parameters, against ``rollout_reference_batched``, on the resident path
    (D=4 and D=6 at M=37) and the global one (M=320)."""
    t_len, samples = 12, 5
    args = _batched_inputs(cuda, dtype, d, m, t_len, samples)
    if not with_q:
        args["q_sqrt"] = None
    noise = 0.1 * torch.randn(samples, t_len, d, dtype=dtype, device=cuda)
    before = ro.rollout.launches
    xk, vk = ro.rollout_batched(**args, noise=noise)
    torch.cuda.synchronize()
    assert ro.rollout.launches == before + 1
    plan = ro.rollout.last_plan
    assert plan.resident is resident
    xr, vr = ro.rollout_reference_batched(**args, noise=noise)
    if dtype == torch.float64:
        tol, h = dict(rtol=1e-9, atol=1e-12), t_len
    else:
        tol, h = dict(rtol=1e-4, atol=1e-5), 10
    torch.testing.assert_close(xk[:, :h], xr[:, :h], **tol)
    torch.testing.assert_close(vk[:, :h], vr[:, :h], **tol)
    # each sample ran on its own parameters
    assert not torch.allclose(vk[0], vk[1])


def test_per_sample_kernel_with_identical_samples_is_the_shared_kernel(cuda):
    """Per-sample strides over S copies of one parameter set give the shared
    launch's result bit for bit (same kernel, same Philox counters)."""
    args = _inputs(cuda, torch.float64, d=4, m=37)
    kp, z, lm_inv, u, q_sqrt, q, x0, ctrl = args
    s = 6
    rep = lambda t: t[None].expand((s,) + t.shape).contiguous()
    xs, vs = ro.rollout(*args, s, generator=torch.Generator().manual_seed(2))
    xb, vb = ro.rollout_batched(
        KernelParams(rep(kp.log_variance), rep(kp.log_lengthscales)), rep(z),
        rep(lm_inv), rep(u), rep(q_sqrt), rep(q), rep(x0), ctrl,
        generator=torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    assert torch.equal(xs, xb) and torch.equal(vs, vb)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per_sample", [False, True])
def test_offset_launch_is_the_whole_launchs_rows(cuda, dtype, per_sample):
    """A launch of rows [r0, r1) with ``row_offset=r0`` (one launch a
    process of a sharded run) gives rows r0..r1 of one launch of all rows,
    bit for bit, and equals the plain version with the same offset."""
    s, t_len = 8, 12
    seeded = lambda: torch.Generator().manual_seed(5)
    if per_sample:
        args = _batched_inputs(cuda, dtype, 4, 37, t_len, s)
        cut = lambda a, r0, r1: {k: (KernelParams(v.log_variance[r0:r1],
                                                  v.log_lengthscales[r0:r1])
                                     if k == "kparams" else
                                     v if k == "controls" else v[r0:r1])
                                 for k, v in a.items()}
        whole = ro.rollout_batched(**args, generator=seeded())
        launch = lambda r0, r1, fn=ro.rollout_batched: fn(
            **cut(args, r0, r1), generator=seeded(), row_offset=r0)
        plain = ro.rollout_reference_batched
    else:
        args = _inputs(cuda, dtype, d=4, m=37, t_len=t_len)
        whole = ro.rollout(*args, s, generator=seeded())
        launch = lambda r0, r1, fn=ro.rollout: fn(
            *args, r1 - r0, generator=seeded(), row_offset=r0)
        plain = ro.rollout_reference
    for r0, r1 in [(0, 4), (4, 8), (3, 6)]:
        xs, vs = launch(r0, r1)
        torch.cuda.synchronize()
        assert torch.equal(xs, whole[0][r0:r1])
        assert torch.equal(vs, whole[1][r0:r1])
        xr, vr = launch(r0, r1, plain)
        tol = (dict(rtol=1e-9, atol=1e-12) if dtype == torch.float64
               else dict(rtol=1e-4, atol=1e-5))
        torch.testing.assert_close(xs[:, :10], xr[:, :10], **tol)
        torch.testing.assert_close(vs[:, :10], vr[:, :10], **tol)


@pytest.mark.parametrize("dtype,m,resident", [(torch.float32, 512, False),
                                              (torch.float64, 100, True)])
@pytest.mark.parametrize("given_noise", [False, True])
def test_grouped_launch_is_each_groups_own_launch(cuda, dtype, m, resident,
                                                  given_noise):
    """One grouped launch of three parameter sets with ragged lengths (13,
    9, 4 steps), 5 rows each at ``row_offset`` 3, against a launch of each
    group alone with the same generator or the same given noise: bit for
    bit, zero past each group's length; and against the plain grouped
    version.  M=512 fp32 takes the global plan, M=100 fp64 the shared
    one."""
    lens, r = (13, 9, 4), 5
    sets = [_inputs(cuda, dtype, d=4, m=m, t_len=max(lens), seed=g)
            for g in range(len(lens))]
    controls = [s[7][:t] for s, t in zip(sets, lens)]
    stack = lambda k: torch.stack([s[k] for s in sets])
    kp = KernelParams(torch.stack([s[0].log_variance for s in sets]),
                      torch.stack([s[0].log_lengthscales for s in sets]))
    args = [kp] + [stack(k) for k in range(1, 7)]
    noise = [torch.randn(r, t, 4, dtype=dtype, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(60 + g))
             for g, t in enumerate(lens)]
    if given_noise:
        draws = lambda: dict(noise=noise)
        own = lambda g: dict(noise=noise[g])
    else:
        seeded = lambda: [torch.Generator().manual_seed(40 + g)
                          for g in range(len(lens))]
        draws = lambda: dict(generators=seeded())
        own = lambda g, gens=seeded(): dict(generator=gens[g])
    before = (ro.rollout.launches, ro.rollout.grouped_launches)
    xs, vs = ro.rollout_grouped(*args, controls, r, row_offset=3, **draws())
    torch.cuda.synchronize()
    assert (ro.rollout.launches, ro.rollout.grouped_launches) == (
        before[0] + 1, before[1] + 1)
    assert ro.rollout.last_groups == 3
    assert ro.rollout.last_plan.resident is resident
    assert ro.rollout.log[-1][0] == 3 * r
    for g, (s, c) in enumerate(zip(sets, controls)):
        x1, v1 = ro.rollout(*s[:7], c, r, row_offset=3, **own(g))
        torch.cuda.synchronize()
        t = lens[g]
        assert torch.equal(xs[g, :, :t], x1) and torch.equal(vs[g, :, :t], v1)
        assert not xs[g, :, t:].any() and not vs[g, :, t:].any()
    assert ro.rollout.last_groups == 1
    xr, vr = ro.rollout_reference_grouped(*args, controls, r, row_offset=3,
                                          **draws())
    if dtype == torch.float64:
        tol, h = dict(rtol=1e-9, atol=1e-12), max(lens)
    else:
        tol, h = dict(rtol=1e-4, atol=1e-5), 10
    torch.testing.assert_close(xs[:, :, :h], xr[:, :, :h], **tol)
    torch.testing.assert_close(vs[:, :, :h], vr[:, :, :h], **tol)


@pytest.mark.parametrize("kind", ["shared", "grouped"])
def test_launch_of_no_rows_returns_empty_rows(cuda, kind):
    """A launch of zero rows returns empty (0, T, D) tensors ((1, 0, T, D)
    for one group) without error."""
    args = _inputs(cuda, torch.float32, d=4, m=37, t_len=6)
    kp = args[0]
    if kind == "shared":
        xs, vs = ro.rollout(*args, 0)
        shape = (0, 6, 4)
    else:
        one = lambda t: t[None]
        xs, vs = ro.rollout_grouped(
            KernelParams(one(kp.log_variance), one(kp.log_lengthscales)),
            *[one(t) for t in args[1:7]], [args[7]], 0,
            generators=[torch.Generator().manual_seed(1)])
        shape = (1, 0, 6, 4)
    torch.cuda.synchronize()
    assert xs.shape == shape and vs.shape == shape


def test_six_dataset_evaluate_is_one_grouped_launch(cuda):
    """``MultiDatasetTrainer.evaluate`` of the six datasets (C4, M=16,
    fp32): one launch of six groups, and the scores of each dataset's own
    ``collect_posterior`` launch with the same generator."""
    import dataclasses

    from ffvd_tpu_torch.config import DATASETS, FFVDConfig
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.eval.rollout import (collect_posterior,
                                             predict_summary, rmse_nll)
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import SSMData
    from ffvd_tpu_torch.parallel import MultiDatasetTrainer, stack_datasets
    from ffvd_tpu_torch.parallel.sharding import member
    data, params, lens = stack_datasets(DATASETS, device=cuda,
                                        dtype=torch.float32, m=16)
    cfg = FFVDConfig(dataset="ballbeam", case=4, num_inducing=16)
    mdt = MultiDatasetTrainer(cfg, data)
    state = mdt.init_state(params)
    dss = [create_dataset(n) for n in DATASETS]
    before = ro.rollout.launches
    res = mdt.evaluate(state, dss, lens, horizon=512,
                       generator=torch.Generator().manual_seed(3))
    assert ro.rollout.launches == before + 1
    assert ro.rollout.last_groups == len(DATASETS)
    g = torch.Generator().manual_seed(3)
    gens = [torch.Generator().manual_seed(ro.draw_seed(g)) for _ in dss]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    with torch.no_grad():
        for i, (ds, n) in enumerate(zip(dss, lens)):
            p = member(state.params, i)
            p = dataclasses.replace(p, x=p.x[:n + 1])
            tr = Trainer(cfg, SSMData(y=as_t(ds.y_train),
                                      control=as_t(ds.control)))
            xs, vs, _ = collect_posterior(tr, tr.init_state(p), ds.n_test,
                                          generator=gens[i])
            py, pv, _ = predict_summary(p, xs, vs)
            rmse, nll = rmse_nll(as_t(ds.y_test), py, pv, ds.y_train_std,
                                 horizon=512)
            assert res[ds.name]["rmse"] == pytest.approx(float(rmse),
                                                         rel=1e-6)
            assert res[ds.name]["nll"] == pytest.approx(float(nll), rel=1e-6)


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    args = _inputs(cuda, torch.float32)
    with pytest.raises(ValueError, match="float32/float64"):
        ro.rollout(*[a.half() if torch.is_tensor(a) else
                     KernelParams(a.log_variance.half(),
                                  a.log_lengthscales.half())
                     for a in args], 2)
    noise = torch.zeros(2, 50, 3, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ro.rollout(*args, 2, noise=noise)


def _pg_model(device, n=30, d=2, m=6, u_dim=1, seed=0):
    """A small C6 model on ``device`` (fp64), from a seed."""
    from ffvd_tpu_torch.model.params import SSMData, params_from_numpy
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    din = d + u_dim
    leaves = {"x": 0.5 * rnd(n + 1, d), "u": rnd(m, d), "z": rnd(m, din),
              "kernel.log_variance": torch.log(0.2 + rnd(d).abs()),
              "kernel.log_lengthscales": torch.log(0.5 + rnd(d, din).abs()),
              "log_q": torch.log(0.05 + 0.2 * rnd(d).abs()),
              "c": rnd(d, 1), "d": rnd(1), "log_rchol": torch.tensor(
                  [[-1.2]], dtype=torch.float64)}
    data = SSMData(y=rnd(n, 1).to(device), control=rnd(2 * n, u_dim)
                   .to(device))
    return params_from_numpy({k: v.numpy() for k, v in leaves.items()},
                             device=device), data


@pytest.mark.parametrize("ancestor", [True, False])
def test_pg_sweep_on_cuda_equals_cpu(cuda, ancestor):
    """One fp64 sweep with the same injected draws: identical resampling
    indices, x within rtol 1e-9; and the recursion syncs nothing."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference import particle_gibbs as pg
    cfg = FFVDConfig(case=6, num_inducing=6, x_dim=2, pg_particles=16,
                     pg_ancestor_trace=ancestor)
    style = pg.pg_ancestor_style if ancestor else pg.pg_reference_style
    runs, draws = [], None
    for dev in ("cpu", cuda):
        params, data = _pg_model(dev)
        if draws is None:
            draws = pg.pg_draws(cfg, params, torch.Generator().manual_seed(5))
        dr = {k: v.to(dev) for k, v in draws.items()}
        pre = kernel_precal(cfg.kernel_type, params.kernel, params.z,
                            cfg.jitter)
        if dev == cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            runs.append(style(cfg, params, pre, data, dr))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    (xc, sc, pc), (xg, sg, pgk) = runs
    for k, v in pc.items():
        assert torch.equal(pgk[k].cpu(), v), k
    torch.testing.assert_close(xg.cpu(), xc, rtol=1e-9, atol=1e-12)
    for k, v in sc.items():
        torch.testing.assert_close(sg[k].cpu(), v, rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", [4, 5])
def test_linear_rollout_on_cuda(cuda, case):
    """The LinearK recursion on the card equals the CPU's (fp64, rtol
    1e-9) and launches no kernel."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.rollout import collect_posterior
    from ffvd_tpu_torch.inference.trainer import Trainer
    cfg = FFVDConfig(case=case, kernel_type="LinearK", num_inducing=6,
                     x_dim=2, jitter=1e-3, posterior_sample_spacing=2)
    noise = torch.randn(3, 15, 2, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))
    thin, runs = None, []
    for dev in ("cpu", cuda):
        params, data = _pg_model(dev, n=20)
        tr = Trainer(cfg, data)
        state = tr.init_state(params)
        if case == 5 and thin is None:
            g = torch.Generator().manual_seed(2)
            thin = {k: torch.randn((3, 2) + tuple(v.shape), generator=g,
                                   dtype=torch.float64)
                    for k, v in tr.subset.split(params).items()}
        before = ro.rollout.launches
        xs, vs, _ = collect_posterior(
            tr, state, 15, num=3, noise=noise.to(dev),
            thin_noise=None if thin is None else
            {k: v.to(dev) for k, v in thin.items()})
        assert ro.rollout.launches == before
        runs.append((xs.cpu(), vs.cpu()))
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


def _deep_model(device, n=30, seed=0):
    """``_pg_model`` with one hidden layer of the head's shapes, its
    inducing outputs non-zero."""
    import dataclasses
    from ffvd_tpu_torch.model.params import HiddenLayerParams
    params, data = _pg_model(device, n=n, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    layer = HiddenLayerParams(
        u=0.5 * rnd(6, 2).to(device), z=rnd(6, 3).to(device),
        kernel=KernelParams(torch.log(0.1 + 0.3 * rnd(2).abs()).to(device),
                            torch.log(0.7 + rnd(2, 3).abs()).to(device)))
    return dataclasses.replace(params, hidden=(layer,)), data


@pytest.mark.parametrize("case", [4, 5])
def test_deep_rollout_on_cuda_equals_cpu(cuda, case):
    """The deep recursion (iid in C4; thinned with per-sub-step inter-layer
    normals in C5) on the card equals the CPU's with the same injected
    noise (fp64, rtol 1e-9) and launches no kernel."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.rollout import collect_posterior
    from ffvd_tpu_torch.inference.trainer import Trainer
    cfg = FFVDConfig(case=case, num_inducing=6, x_dim=2, n_layers=2,
                     posterior_sample_spacing=2)
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(3, 15, 2, dtype=torch.float64, generator=g)
    hidden = [torch.randn(3, 15, 2, dtype=torch.float64, generator=g)]
    thin = prop = None
    runs = []
    for dev in ("cpu", cuda):
        params, data = _deep_model(dev)
        tr = Trainer(cfg, data)
        state = tr.init_state(params)
        if case == 5 and thin is None:
            thin = {k: torch.randn((3, 2) + tuple(v.shape), generator=g,
                                   dtype=torch.float64)
                    for k, v in tr.subset.split(params).items()}
            prop = [torch.randn(3, 2, 30, 2, generator=g,
                                dtype=torch.float64)]
        before = ro.rollout.launches
        xs, vs, _ = collect_posterior(
            tr, state, 15, num=3, noise=noise.to(dev),
            hidden_noise=[h.to(dev) for h in hidden],
            thin_noise=None if thin is None else
            {k: v.to(dev) for k, v in thin.items()},
            thin_prop=None if prop is None else [p.to(dev) for p in prop])
        assert ro.rollout.launches == before
        runs.append((xs.cpu(), vs.cpu()))
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("deep", [False, True])
def test_windowed_step_on_cuda_equals_cpu(cuda, deep):
    """One windowed C5 outer step (21 SG-HMC sub-steps and the Adam step,
    each on its own window, deep with inter-layer normals) with the same
    injected draws: the card equals the CPU (fp64, rtol 1e-9), and the
    window starts stay on the card."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.sghmc import tree_normals
    from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
    cfg = FFVDConfig(case=5, num_inducing=6, x_dim=2, minibatch_size=8,
                     n_layers=1 + int(deep))
    g = torch.Generator().manual_seed(4)
    draws, runs = None, []
    for dev in ("cpu", cuda):
        params, data = (_deep_model if deep else _pg_model)(dev)
        tr = Trainer(cfg, data)
        state = tr.init_state(params)
        if draws is None:
            draws = tr.grad_draws(len(SUBSTEP_FLAGS) + 1, g, params.x)
            draws["noise"] = tree_normals(tr.subset.split(params), g,
                                          (len(SUBSTEP_FLAGS),))
            draws["feed"] = 0
        on = {k: (v.to(dev) if torch.is_tensor(v) else
                  [p.to(dev) for p in v] if isinstance(v, list) else
                  {kk: vv.to(dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else v)
              for k, v in draws.items()}
        assert on["starts"].device.type == torch.device(dev).type
        nll = tr.outer_step(state, **on)
        runs.append((nll.cpu(), {k: v.detach().cpu() for k, v
                                 in state.params.leaves().items()}))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-9, atol=0)
    for k, v in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], v, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ds64_step_on_cuda_equals_cpu(cuda, dtype):
    """One ds64 C4 outer step (the collapsed segment in float64 on the card)
    with the same leaves: the card's nll and leaves equal the CPU's (fp64
    leaves rtol 1e-9; fp32 leaves rtol 1e-5, one Adam step)."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    cfg = FFVDConfig(case=4, num_inducing=6, x_dim=2,
                     collapse_precision="ds64")
    runs = []
    for dev in ("cpu", cuda):
        params, data = _pg_model(dev)
        params = GPSSMParams.from_leaves({k: v.to(dtype) for k, v
                                          in params.leaves().items()})
        data = SSMData(y=data.y.to(dtype), control=data.control.to(dtype))
        tr = Trainer(cfg, data)
        state = tr.init_state(params)
        nll = tr.outer_step(state)
        runs.append((nll.cpu(), {k: v.detach().cpu() for k, v
                                 in state.params.leaves().items()}))
    tol = (dict(rtol=1e-9, atol=1e-12) if dtype == torch.float64
           else dict(rtol=1e-5, atol=1e-6))
    torch.testing.assert_close(runs[1][0], runs[0][0], **tol)
    for k, v in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], v, **tol)

"""Port parity, the SG-HMC update: ``sghmc_step`` and the log clips against
``ffvd_tpu/inference/sghmc.py`` and ``ffvd_tpu/inference/trainer.py``.

Inputs are made with numpy from a seed and the same normals are given to
both packages (``noise=``).  The port does the JAX update's operations in
the same order, so fp64 results agree at rtol 1e-13 (measured ≤4e-16, not
always to the last bit: XLA may fuse a multiply and an add).  The
sampler's stationary variance on a Gaussian target is checked as
``tests/test_inference.py::test_sghmc_samples_gaussian_target`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.inference.sghmc import SGHMCState as JState
from ffvd_tpu.inference.sghmc import sghmc_step as j_sghmc_step
from ffvd_tpu.inference.trainer import clip_log_leaves as j_clip_log_leaves
from ffvd_tpu.inference.trainer import sanitize_grads as j_sanitize_grads

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.sghmc import (SGHMCState, sghmc_init,
                                            sghmc_step, tree_normals)
from ffvd_tpu_torch.inference.trainer import (SubsetOps, clip_log_leaves,
                                              label_tree, sanitize_grads)

torch.set_num_threads(1)

PATHS = ("u", "kernel.log_variance", "kernel.log_lengthscales")
SHAPES = {"u": (7, 3), "kernel.log_variance": (3,),
          "kernel.log_lengthscales": (3, 4)}


def _inputs(seed, grad_scale=1.0):
    rng = np.random.RandomState(seed)
    mk = lambda f: {k: f(SHAPES[k]) for k in PATHS}
    return dict(
        theta=mk(lambda s: rng.randn(*s)),
        # a few gradients far above the preconditioner's RMS, so the spike
        # clip acts on some entries and leaves the rest
        grads=mk(lambda s: grad_scale * rng.randn(*s)
                 * np.where(rng.rand(*s) < 0.3, 60.0, 1.0)),
        xi=mk(lambda s: rng.rand(*s) + 0.5), g=mk(lambda s: rng.randn(*s)),
        g2=mk(lambda s: rng.rand(*s) * 0.5 + 1e-3),
        p=mk(lambda s: 0.5 * rng.randn(*s)),
        noise=mk(lambda s: rng.randn(*s)))


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("burn_in", [True, False])
@pytest.mark.parametrize("p_clip,spike_clip", [(None, None), (1.0, None),
                                               (None, 20.0), (0.05, 2.0)])
def test_sghmc_step_matches_jax(burn_in, p_clip, spike_clip):
    inp = _inputs(1, grad_scale=3.0)
    kw = dict(epsilon=0.01, mdecay=0.05, x_n=501, burn_in=burn_in,
              p_clip=p_clip, spike_clip=spike_clip)
    jtheta, jstate = jax.jit(lambda th, gr, st, nz: j_sghmc_step(
        th, gr, st, jax.random.key(0), noise=nz, **kw))(
        _j(inp["theta"]), _j(inp["grads"]),
        JState(xi=_j(inp["xi"]), g=_j(inp["g"]), g2=_j(inp["g2"]),
               p=_j(inp["p"])), _j(inp["noise"]))
    theta, state = sghmc_step(
        _t(inp["theta"]), _t(inp["grads"]),
        SGHMCState(xi=_t(inp["xi"]), g=_t(inp["g"]), g2=_t(inp["g2"]),
                   p=_t(inp["p"])), noise=_t(inp["noise"]), **kw)
    for k in PATHS:
        np.testing.assert_allclose(theta[k].numpy(), np.asarray(jtheta[k]),
                                   rtol=1e-13, atol=0, err_msg=k)
        for f in ("xi", "g", "g2", "p"):
            np.testing.assert_allclose(
                getattr(state, f)[k].numpy(),
                np.asarray(getattr(jstate, f)[k]), rtol=1e-13, atol=0,
                err_msg=f"{f}.{k}")
    if not burn_in:
        # outside burn-in the preconditioner does not adapt
        for f in ("xi", "g", "g2"):
            assert torch.equal(getattr(state, f)["u"], _t(inp[f])["u"])
    if p_clip is not None:
        assert float(max(v.abs().max() for v in state.p.values())) \
            <= p_clip + 1e-15


def test_spike_clip_acts_on_spikes_only():
    """Clipped and unclipped steps differ exactly where |∇| exceeds
    max(20·√(g²+1e-16), 1)."""
    inp = _inputs(2, grad_scale=3.0)
    kw = dict(epsilon=0.01, mdecay=0.05, x_n=501, burn_in=False,
              noise=_t(inp["noise"]))
    st = lambda: SGHMCState(xi=_t(inp["xi"]), g=_t(inp["g"]),
                            g2=_t(inp["g2"]), p=_t(inp["p"]))
    free, _ = sghmc_step(_t(inp["theta"]), _t(inp["grads"]), st(), **kw)
    clip, _ = sghmc_step(_t(inp["theta"]), _t(inp["grads"]), st(),
                         spike_clip=20.0, **kw)
    for k in PATHS:
        bound = np.maximum(20.0 * np.sqrt(inp["g2"][k] + 1e-16), 1.0)
        spikes = np.abs(inp["grads"][k]) > bound
        moved = (free[k] != clip[k]).numpy()
        np.testing.assert_array_equal(moved, spikes, err_msg=k)
    assert any(np.any(np.abs(inp["grads"][k]) > 20.0) for k in PATHS)


def test_sanitize_grads_matches_jax():
    g = np.array([1.0, np.nan, np.inf, -np.inf, -3e7, 2e6, -0.5])
    for clip in (1e6, 10.0, None):
        (out,) = sanitize_grads([torch.tensor(g)], clip)
        want = jax.jit(lambda a: j_sanitize_grads({"a": a}, clip))(
            jnp.asarray(g))["a"]
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("clip", [(-30.0, 12.0), 12.0, None, (-5.0, 5.0)])
def test_clip_log_leaves_matches_jax(clip):
    """Asymmetric default bounds (-30, 12), a symmetric scalar, none; only
    paths containing 'log' are clipped, log_rchol's strictly-lower raw
    entries included (tests/test_fp32_robustness.py:42-75,
    tests/test_inference.py:265-290)."""
    rng = np.random.RandomState(5)
    tree = {"x": 40 * rng.randn(4, 2), "u": 40 * rng.randn(3, 2),
            "kernel.log_variance": np.array([-13.8, -35.0, 25.0, 3.0]),
            "kernel.log_lengthscales": 40 * rng.randn(2, 3),
            "log_q": np.array([-13.8, -35.0, 25.0]),
            "log_rchol": np.array([[1.0, 0.0], [-50.0, 40.0]])}
    out = clip_log_leaves(_t(tree), clip)
    jout = jax.jit(lambda t: j_clip_log_leaves(t, clip))(_j(tree))
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    if clip == (-30.0, 12.0):
        np.testing.assert_array_equal(out["log_q"].numpy(),
                                      [-13.8, -30.0, 12.0])
        np.testing.assert_array_equal(out["log_rchol"].numpy(),
                                      [[1.0, 0.0], [-30.0, 12.0]])
        np.testing.assert_array_equal(out["x"].numpy(), tree["x"])
    if clip is None:
        t = _t(tree)
        assert clip_log_leaves(t, None) is t


def test_hyperparameter_subset_clip_uses_config_bounds():
    cfg = FFVDConfig(case=4, hyperparameter_sampling=True)
    ops = SubsetOps(label_tree(cfg))
    assert ops.paths == ("log_q", "c", "d", "log_rchol")
    sub = {"log_q": torch.tensor([40.0, -40.0]), "c": torch.tensor([99.0]),
           "d": torch.tensor([-99.0]),
           "log_rchol": torch.tensor([[50.0]])}
    out = clip_log_leaves(sub, cfg.log_clip_bounds)
    assert out["log_q"].tolist() == [12.0, -30.0]
    assert out["c"].tolist() == [99.0] and out["d"].tolist() == [-99.0]
    assert out["log_rchol"].tolist() == [[12.0]]


def test_sghmc_samples_gaussian_target():
    """Stationary θ-marginal of the scale-adapted SG-HMC on nll = λθ²/2
    targets exp(−X_N·nll): Var[θ] ≈ 1/(X_N·λ) (continuous-time limit)."""
    lam, x_n, dim = 2.0, 50, 512
    gen = torch.Generator().manual_seed(1)
    theta = {"t": torch.zeros(dim, dtype=torch.float64)}
    state = sghmc_init(theta)
    trace = []
    for i in range(4000):
        theta, state = sghmc_step(theta, {"t": lam * theta["t"]}, state,
                                  epsilon=0.01, mdecay=0.05, x_n=x_n,
                                  burn_in=i < 500, generator=gen)
        if i >= 2000:
            trace.append(theta["t"])
    var = float(torch.stack(trace).var())
    expected = 1.0 / (x_n * lam)
    assert 0.6 * expected < var < 1.6 * expected, (var, expected)


def test_tree_normals_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        tree_normals({"a": torch.zeros(2)}, None)
    z = tree_normals({"a": torch.zeros(2, dtype=torch.float64)},
                     torch.Generator().manual_seed(0), (5,))
    assert z["a"].shape == (5, 2) and z["a"].dtype == torch.float64

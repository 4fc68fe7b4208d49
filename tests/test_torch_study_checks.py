"""The CPU checks behind the study pins the card missed
(``tests/test_torch_study_artifacts.py``): each arm's case against the JAX
package with the JAX draws injected, over a longer stretch than the
trainer tests' 3 iterations.

- actuator C4 (P1): 200 iterations, the trace at rtol 1e-10 (C4 draws
  nothing), then ``evaluate()`` fed JAX's rollout normals at rtol 1e-6, as
  ``tests/test_torch_eval.py`` holds ballbeam;
- ballbeam C2 (P2): 66 outer iterations with JAX's sampler normals and
  feed indices, so the 64-slot window fills and the feeds wrap it (the
  3-iteration trainer test wraps a 2-slot window); the trace at rtol
  1e-10, the leaves, whose sampled part's roundoff the sampler amplifies,
  at 1e-5;
- flutter C5 (P5): 3 outer iterations with JAX's sampler draws, native
  fp64 against JAX's native at rtol 1e-9, and ``collapse_precision=
  "ds64"`` (fp64 leaves) against JAX's native fp64 too, at rtol 1e-6: the
  port's ds64 is the IEEE float64 segment, fed and read in float32, so its
  sampler gradients are fp64's up to that rounding;
- flutter C5 under ds64 in fp32, as the card runs it (P5): the nll and
  the gradient every SG-HMC sub-step takes, at the float32 warm start,
  against JAX's double-single in fp32 (run eagerly, ≈80 s: jitting JAX's
  double-single outer step on the CPU did not finish in 15 minutes), and
  both against JAX's native fp64 at the same float32 leaves;
- ballbeam C6 (P6): 12 iterations with JAX's sweep draws at rtol 1e-12.

Over some hundreds of iterations two correct implementations part anyway
(their roundoff grows), so each check is held over a stretch where it has
not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.api import FFVDModel as JFFVDModel
from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
from ffvd_tpu_torch.inference.trainer import Trainer, grads_of
from ffvd_tpu_torch.model.params import (SSMData, init_params_from_warmstart,
                                         params_to_numpy)
from tests import test_torch_trainer_pg as pg_parity
from tests import test_torch_trainer_sghmc as sghmc_parity
from tests.test_torch_elbo import _grad_leaves
from tests.test_torch_eval import _jax_rollout_noise
from tests.test_torch_particle_gibbs import jax_params

torch.set_num_threads(2)

# The leaves whose gradient passes through the collapsed segment.
SEGMENT = ("z", "kernel.log_variance", "kernel.log_lengthscales")


def _leaves_close(state, jstate, rtol, atol):
    jleaves = sghmc_parity.by_path(jstate.params)
    for k, v in state.params.leaves().items():
        scale = max(float(np.max(np.abs(jleaves[k]))), 1e-300)
        np.testing.assert_allclose(v.detach().numpy(), jleaves[k],
                                   rtol=rtol, atol=atol * scale, err_msg=k)


def test_actuator_c4_matches_jax():
    """P1's actuator arm: training and the evaluation with JAX's rollout
    normals."""
    jm = JFFVDModel(JConfig(dataset="actuator", case=4))
    jm.fit(200)
    noise = _jax_rollout_noise(jm.key, 10, jm.dataset.n_test, 4)
    jres = jm.evaluate()
    tm = FFVDModel(FFVDConfig(dataset="actuator", case=4), device="cpu")
    tm.fit(200)
    tres = tm.evaluate(noise=torch.tensor(noise))
    np.testing.assert_allclose(tm.nll_trace.numpy(),
                               np.asarray(jm.nll_trace), rtol=1e-10)
    for key in ("rmse", "nll"):
        np.testing.assert_allclose(tres[key], jres[key], rtol=1e-6)
    np.testing.assert_allclose(tres["predict_y"], jres["predict_y"],
                               rtol=1e-6, atol=1e-9)


def test_c2_past_the_window_matches_jax():
    """P2's case: C2 with JAX's draws over 66 outer iterations, past the
    64-slot window: the nll trace at rtol 1e-10, the leaves at 1e-5.  The
    sampled u parts from JAX's smoothly, about tenfold every 6 iterations
    and with no step at the window's wrap (5e-13 after 12 iterations, 8e-12
    after 30, 2e-7 to 2e-6 after 66): roundoff the sampler's dynamics
    amplify, where a fault would show as a step."""
    kw = dict(case=2)
    jstate, jtrace, draws, _ = sghmc_parity._jax_run(kw, 66)
    tr, state = sghmc_parity._port(kw)
    state, trace = tr.run(state, 66, draws=draws)
    np.testing.assert_allclose(trace.numpy(), jtrace, rtol=1e-10)
    _leaves_close(state, jstate, rtol=1e-5, atol=1e-12)
    assert state.window_count == int(jstate.window_count) == 64


@functools.lru_cache(maxsize=None)
def _jax_flutter_c5(n):
    """JAX's native fp64 flutter C5 over ``n`` outer iterations, with its
    draws: one run for both precisions of the port."""
    return sghmc_parity._jax_run(dict(dataset="flutter", case=5), n)


@pytest.mark.parametrize("precision, rtol, atol", [
    ("native", 1e-9, 1e-12), ("ds64", 1e-6, 1e-7)])
def test_flutter_c5_matches_jax_fp64(precision, rtol, atol):
    """P5's case: flutter C5 with JAX's draws; native and ds64 both land
    on JAX's native fp64 run."""
    jstate, jtrace, draws, _ = _jax_flutter_c5(3)
    tr, state = sghmc_parity._port(dict(dataset="flutter", case=5,
                                        collapse_precision=precision))
    state, trace = tr.run(state, 3, draws=draws)
    np.testing.assert_allclose(trace.numpy(), jtrace, rtol=rtol)
    _leaves_close(state, jstate, rtol=rtol, atol=atol)


def _jax_value_grad(precision, leaves, dtype, jit):
    """JAX's flutter C5 nll and gradient at ``leaves`` in ``dtype``."""
    ds = j_create_dataset("flutter")
    data = JSSMData(y=jnp.asarray(ds.y_train, dtype),
                    control=jnp.asarray(ds.control, dtype))
    tr = JTrainer(JConfig(dataset="flutter", case=5,
                          collapse_precision=precision), data)
    f = jax.value_and_grad(tr.nll_fn)
    p = jax_params({k: np.asarray(v, dtype) for k, v in leaves.items()})
    v, g = (jax.jit(f) if jit else f)(p, data)
    return float(v), {k: np.asarray(a, np.float64)
                      for k, a in _grad_leaves(g).items()}


def _port_value_grad(precision, params, dtype):
    ds = create_dataset("flutter")
    tr = Trainer(FFVDConfig(dataset="flutter", case=5,
                            collapse_precision=precision),
                 SSMData(y=torch.as_tensor(ds.y_train, dtype=dtype),
                         control=torch.as_tensor(ds.control, dtype=dtype)))
    req = {k: v.detach().to(dtype).requires_grad_(True)
           for k, v in params.leaves().items()}
    nll = tr.train_nll(type(params).from_leaves(req))
    return float(nll.detach()), {k: g.numpy().astype(np.float64) for k, g in
                        zip(req, grads_of(nll, list(req.values())))}


def _rel(g, ref):
    """Each leaf's largest difference over the reference leaf's largest
    magnitude."""
    return {k: float(np.abs(g[k] - ref[k]).max()
                     / max(np.abs(ref[k]).max(), 1e-300)) for k in ref}


def test_flutter_c5_ds64_fp32_matches_jax_double_single():
    """P5's arm as the card runs it, fp32 leaves under ds64: the port's nll
    and gradient at the float32 warm start against JAX's double-single in
    fp32 (the value at rtol 1e-6, each leaf within 1e-4 of its largest
    gradient; the port's native fp32 misses that on z), and against JAX's
    native fp64 at the same leaves: the port within 1e-5, and on the
    segment's leaves at least ten times closer than JAX's double-single."""
    p32 = init_params_from_warmstart(load_warmstart("flutter"),
                                     dtype=torch.float32)
    leaves = params_to_numpy(p32)
    v_ds, g_ds = _jax_value_grad("ds64", leaves, np.float32, jit=False)
    v64, g64 = _jax_value_grad("native", leaves, np.float64, jit=True)
    v, g = _port_value_grad("ds64", p32, torch.float32)
    _, g_native = _port_value_grad("native", p32, torch.float32)

    np.testing.assert_allclose(v, v_ds, rtol=1e-6)
    np.testing.assert_allclose(v, v64, rtol=1e-6)
    to_jax_ds = _rel(g, g_ds)
    assert max(to_jax_ds.values()) < 1e-4, to_jax_ds
    assert _rel(g_native, g_ds)["z"] > 1e-4
    to_fp64, jax_to_fp64 = _rel(g, g64), _rel(g_ds, g64)
    assert max(to_fp64.values()) < 1e-5, to_fp64
    for k in SEGMENT:
        assert to_fp64[k] < 0.1 * jax_to_fp64[k], (k, to_fp64, jax_to_fp64)


def test_c6_12_iterations_match_jax():
    """P6's case: ancestor-traced C6 with JAX's sweep draws over 12
    iterations."""
    kw = dict(dataset="ballbeam", case=6)
    jstate, jtrace, draws = pg_parity._jax_run(JConfig(**kw), 12)
    cfg = FFVDConfig(**kw)
    ds = create_dataset(cfg.dataset)
    tr = Trainer(cfg, SSMData(y=torch.as_tensor(ds.y_train),
                              control=torch.as_tensor(ds.control)),
                 pg_fn=make_pg_fn(cfg))
    state = tr.init_state(init_params_from_warmstart(
        load_warmstart(cfg.dataset)))
    state, trace = tr.run(state, 12, draws=draws)
    np.testing.assert_allclose(trace.numpy(), jtrace, rtol=1e-12)
    _leaves_close(state, jstate, rtol=1e-9, atol=1e-12)

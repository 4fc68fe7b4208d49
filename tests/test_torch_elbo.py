"""Port parity (c): the ELBO, its gradients and q(U).

1. Every term and every gradient block of the port's ``elbo_terms`` against
   the JAX package's on the ballbeam warm start, collapsed and uncollapsed,
   in fp64: rtol 1e-9 (the two differ in summation order only; gradient
   elements near zero get atol 1e-12).
2. All eight TF golden fixtures, loaded through the port's own vendored
   loader, at the JAX package's own tolerances
   (tests/test_golden_parity.py:23,89,120): terms rtol 5e-7, gradients
   rtol 1e-7, q(U) rtol 1e-7.
3. The four inducing-input priors against the JAX ones.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.model import priors as jpriors
from ffvd_tpu.model.elbo import elbo_terms as j_elbo_terms
from ffvd_tpu.model.elbo import negative_elbo as j_negative_elbo
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.model import priors as tpriors
from ffvd_tpu_torch.model.conditionals import (collapsed_u_posterior,
                                               kernel_precal)
from ffvd_tpu_torch.model.elbo import elbo_terms, gp_inputs
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_params_from_warmstart,
                                         params_from_numpy)
from ffvd_tpu_torch.ops.kernels import KernelParams

torch.set_num_threads(2)

TERMS = ["nll", "nll_log_likelihood", "nll_part_prior", "x_t_prior_Q",
         "nll_reg_trace_inverse_Q_B", "later_term1", "later_term2"]

_j_terms = jax.jit(j_elbo_terms, static_argnames=("u_collapse", "prior_type"))
_j_grad = jax.jit(jax.grad(j_negative_elbo),
                  static_argnames=("u_collapse", "prior_type"))


def _grad_leaves(g):
    return {"x": g.x, "u": g.u, "z": g.z,
            "kernel.log_variance": g.kernel.log_variance,
            "kernel.log_lengthscales": g.kernel.log_lengthscales,
            "log_q": g.log_q, "c": g.c, "d": g.d, "log_rchol": g.log_rchol}


def port_terms_and_grads(params, data, **kw):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.leaves().items()}
    p = type(params).from_leaves(leaves)
    terms = elbo_terms(p, data, **kw)
    grads = torch.autograd.grad(terms["nll"], list(leaves.values()),
                                allow_unused=True)
    g = {k: (np.zeros(tuple(v.shape)) if gr is None else gr.numpy())
         for (k, v), gr in zip(leaves.items(), grads)}
    return {k: float(v.detach()) for k, v in terms.items()}, g


def _ballbeam():
    ds = create_dataset("ballbeam")
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    jds = j_create_dataset("ballbeam")
    jdata = JSSMData(y=jnp.asarray(jds.y_train),
                     control=jnp.asarray(jds.control))
    return data, jdata


@pytest.mark.parametrize("u_collapse", [True, False])
def test_elbo_terms_and_grads_match_jax(u_collapse):
    data, jdata = _ballbeam()
    params = init_params_from_warmstart(load_warmstart("ballbeam"))
    jp = j_init(j_load_warmstart("ballbeam"))
    terms, grads = port_terms_and_grads(params, data, u_collapse=u_collapse)
    jt = _j_terms(jp, jdata, u_collapse=u_collapse)
    assert set(terms) == set(jt.keys())
    for k in jt:
        np.testing.assert_allclose(terms[k], float(jt[k]), rtol=1e-9,
                                   err_msg=k)
    jg = _grad_leaves(_j_grad(jp, jdata, u_collapse=u_collapse))
    for k in LEAF_PATHS:
        np.testing.assert_allclose(grads[k], np.asarray(jg[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("prior_type",
                         ["uniform", "normal", "determinantal", "strauss"])
def test_priors_match_jax(prior_type):
    rng = np.random.RandomState(5)
    z = rng.randn(9, 3)
    lv, ls = np.log(rng.rand(2) + 0.3), np.log(rng.rand(2, 3) + 0.5)
    from ffvd_tpu.ops.kernels import KernelParams as JKP
    jkp = JKP(jnp.asarray(lv), jnp.asarray(ls))
    tkp = KernelParams(torch.as_tensor(lv), torch.as_tensor(ls))
    jv = jax.jit(jpriors.prior_z, static_argnums=(0, 1))(
        prior_type, "SquaredExponential", jkp, jnp.asarray(z))
    tv = tpriors.prior_z(prior_type, "SquaredExponential", tkp,
                         torch.as_tensor(z))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-10, atol=1e-14)
    for kt in ("SquaredExponential", "LinearK"):
        np.testing.assert_allclose(float(tpriors.prior_hyper(kt, tkp)),
                                   float(jpriors.prior_hyper(kt, jkp)),
                                   rtol=1e-12)


def test_elbo_with_prior_types_and_mask_match_jax():
    """Strauss/determinantal priors and a padding mask through the whole
    objective (collapsed), against JAX at rtol 1e-9."""
    data, jdata = _ballbeam()
    params = init_params_from_warmstart(load_warmstart("ballbeam"))
    jp = j_init(j_load_warmstart("ballbeam"))
    mask = np.ones(500)
    mask[450:] = 0.0
    data.mask = torch.as_tensor(mask)
    jdata = JSSMData(y=jdata.y, control=jdata.control, mask=jnp.asarray(mask))
    for prior_type in ("strauss", "determinantal"):
        terms, grads = port_terms_and_grads(params, data,
                                            prior_type=prior_type)
        jt = _j_terms(jp, jdata, u_collapse=True, prior_type=prior_type)
        for k in jt:
            np.testing.assert_allclose(terms[k], float(jt[k]), rtol=1e-9,
                                       err_msg=f"{prior_type} {k}")
        jg = _grad_leaves(_j_grad(jp, jdata, u_collapse=True,
                                  prior_type=prior_type))
        for k in LEAF_PATHS:
            np.testing.assert_allclose(grads[k], np.asarray(jg[k]),
                                       rtol=1e-9, atol=1e-12, err_msg=k)


def test_unported_objective_options_raise():
    data, _ = _ballbeam()
    params = init_params_from_warmstart(load_warmstart("ballbeam"))
    with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
        elbo_terms(params, data, collapse_precision="ds64")
    with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
        elbo_terms(params, data, key=0)


# -- the eight TF golden fixtures -------------------------------------------

GOLDEN_DIR = Path(__file__).parent / "golden"
GOLDEN = [p.name for p in sorted(GOLDEN_DIR.glob("golden_*.npz"))]


def _load_golden(name):
    with np.load(GOLDEN_DIR / name, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


COLLAPSED = [n for n in GOLDEN if bool(_load_golden(n)["u_collapse"])]


def setup_golden(golden):
    """The port's version of tests/test_golden_parity.py::setup_case, with
    the warm start read through the port's vendored loader."""
    name = str(golden["dataset"])
    ds = create_dataset(name)
    params = init_params_from_warmstart(
        load_warmstart(name, int(golden["file_id"])))
    if bool(golden.get("hyperparameter_sampling", False)):
        d, p = params.x.shape[1], params.c.shape[1]
        tree = {k: v.numpy() for k, v in params.leaves().items()}
        tree.update(log_q=np.full((d,), np.log(0.1)), c=np.ones((d, p)),
                    d=np.zeros((p,)), log_rchol=np.full((p, p), np.log(0.1)))
        params = params_from_numpy(tree)
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    return params, data, bool(golden["u_collapse"])


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_terms_and_grads(name):
    golden = _load_golden(name)
    params, data, collapse = setup_golden(golden)
    terms, grads = port_terms_and_grads(params, data, u_collapse=collapse)
    for k in TERMS:
        if k not in golden or (k.startswith("later") and not collapse):
            continue
        np.testing.assert_allclose(terms[k], float(golden[k]), rtol=5e-7,
                                   atol=1e-9, err_msg=f"term {k}")
    pairs = {"grad_x": grads["x"], "grad_z": grads["z"],
             "grad_log_q": grads["log_q"], "grad_c": grads["c"],
             "grad_d": grads["d"], "grad_log_rchol": grads["log_rchol"],
             "grad_log_variance_0": grads["kernel.log_variance"][0],
             "grad_log_lengthscales_0": grads["kernel.log_lengthscales"][0]}
    if not collapse:
        pairs["grad_u"] = grads["u"]
    for k, ours in pairs.items():
        ref = golden[k]
        if ref.size == 0:       # TF returned None gradient (disconnected)
            continue
        np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("name", COLLAPSED)
def test_golden_collapsed_u_posterior(name):
    golden = _load_golden(name)
    params, data, _ = setup_golden(golden)
    pre = kernel_precal("SquaredExponential", params.kernel, params.z)
    u_mean, q_sqrt = collapsed_u_posterior(
        "SquaredExponential", params.kernel, pre, params.z, params.x,
        gp_inputs(params, data), params.q)
    np.testing.assert_allclose(u_mean.numpy(), golden["u_post_mean"],
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(q_sqrt.numpy(), golden["u_post_chol"],
                               rtol=1e-7, atol=1e-9)

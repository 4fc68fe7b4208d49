"""Port parity: the collapsed bound as one float64 segment
(``ffvd_tpu_torch/model/ds_collapse.py``) against the JAX package.

The JAX package computes this segment in double-single arithmetic
(``ffvd_tpu/model/ds_collapse.py``), ≈49 bits; the port computes it in
IEEE float64 at the float32 values of its inputs.  At the small point of
``tests/test_ds_collapse.py`` (D=2, M=12, N=48, Din=3), from numpy seeds:

- JAX's double-single forward, run once (eager, ≈20 s: jitting it on the
  CPU takes minutes), SE and LinearK: the bound's value v = term1 + term2
  + trace within 4e-6·max(|v|, 1), JAX's own bound
  (tests/test_ds_collapse.py:117).  Term by term the port is the closer to
  fp64: LinearK's trace (K_tt − ‖F̃_t‖² cancels fully, Din < M) is
  5.991290e-3 in the port and fp64, 5.995416e-3 in double-single;
- JAX's native fp64 ``kernel_precal`` + ``collapsed_bound_terms`` at the
  float32-rounded inputs, which double-single approximates: the same bound
  on the values, gradients of the kernel hypers, z, x and log Q at rtol
  1e-5 (the port's gradient passes the float32 casts of its inputs);
  masked and with ``gram_scale`` ≠ 1, as a number and as a tensor;
- q(U) at atol 2e-6 and Kmm's factors at atol 1e-6 (lm) / 1e-5 (lm⁻¹)
  against fp64 (tests/test_ds_collapse.py:291-294, 329-333); at a sharp
  point (Q ≈ 2.3e-6) the port's q_sqrt error is under 0.1× the fp32
  path's; at the harsh point past the fp32 Cholesky's reach (lv=8, ls=6)
  values and gradients are finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.model import conditionals as jcond
from ffvd_tpu.model.ds_collapse import ds_collapsed_terms as j_ds_terms
from ffvd_tpu.ops.kernels import KernelParams as JKP

from ffvd_tpu_torch.model import conditionals as cond
from ffvd_tpu_torch.model.ds_collapse import (ds_collapsed_terms,
                                              ds_collapsed_u_posterior,
                                              ds_precal)
from ffvd_tpu_torch.ops.kernels import KernelParams

torch.set_num_threads(2)

D, M, N, DIN = 2, 12, 48, 3
KERNELS = ["SquaredExponential", "LinearK"]
INPUTS = ("log_variance", "log_lengthscales", "z", "x", "xc", "log_q")
GRADS = ("log_variance", "log_lengthscales", "z", "x", "log_q")


def _point(seed=0, dup_frac=0.0, ls=0.0, lv=0.3, log_q=-3.0):
    """The evaluation point of tests/test_ds_collapse.py::_point, fp64."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((M, DIN))
    k = int(M * dup_frac)
    if k:
        z[M - k:] = z[:k] + 1e-5 * rng.standard_normal((k, DIN))
    x = np.cumsum(0.1 * rng.standard_normal((N + 1, D)), 0)
    xc = np.concatenate([x[:-1], rng.standard_normal((N, DIN - D))], 1)
    return {"log_variance": np.full((D,), float(lv)),
            "log_lengthscales": np.full((D, DIN), float(ls)),
            "z": z, "x": x, "xc": xc, "log_q": np.full((D,), log_q)}


def _rounded(p):
    return {k: v.astype(np.float32).astype(np.float64) for k, v in p.items()}


def _port_terms(kt, p, mask=None, gram_scale=1.0, grad=False, **kw):
    """The port's three terms (numpy) and, with ``grad``, the gradient of
    their sum with respect to fp64 leaves."""
    t = {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}
    terms = ds_collapsed_terms(
        kt, KernelParams(t["log_variance"], t["log_lengthscales"]), t["z"],
        t["x"], t["xc"], t["log_q"], mask=mask, gram_scale=gram_scale, **kw)
    vals = np.array([float(v.detach()) for v in terms])
    if not grad:
        return vals, None
    g = torch.autograd.grad(sum(terms), [t[k] for k in GRADS],
                            allow_unused=True)
    return vals, {k: (np.zeros(p[k].shape) if gi is None else gi.numpy())
                  for k, gi in zip(GRADS, g)}


def _j_native(kt, lv, ls, z, x, xc, logq, mask, gram_scale):
    kp = JKP(lv, ls)
    pre = jcond.kernel_precal(kt, kp, z)
    return jnp.stack(jcond.collapsed_bound_terms(
        kt, kp, pre, z, x, xc, jnp.exp(logq), mask=mask,
        gram_scale=gram_scale))


_j_native_terms = jax.jit(_j_native, static_argnums=(0,))
_j_native_grad = jax.jit(jax.grad(lambda *a: jnp.sum(_j_native(*a)),
                                  argnums=(1, 2, 3, 4, 6)),
                         static_argnums=(0,))


def _jax_fp64(kt, p, mask=None, gram_scale=1.0):
    """JAX's fp64 native terms and gradient at ``p`` (taken as given)."""
    args = [jnp.asarray(p[k]) for k in INPUTS]
    m = None if mask is None else jnp.asarray(mask)
    vals = np.asarray(_j_native_terms(kt, *args, m, gram_scale))
    g = _j_native_grad(kt, *args, m, gram_scale)
    return vals, dict(zip(GRADS, (np.asarray(a) for a in g)))


def _within_bound(ours, ref, per_term=True):
    if per_term:
        for a, b in zip(ours, ref):
            assert abs(a - b) <= 4e-6 * max(abs(b), 1.0), (a, b)
    assert abs(sum(ours) - sum(ref)) <= 4e-6 * max(abs(sum(ref)), 1.0)


def _grads_close(ours, ref):
    for k in GRADS:
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5,
                                   atol=1e-12 * max(scale, 1.0), err_msg=k)


@pytest.fixture(scope="module")
def jax_double_single():
    """JAX's double-single forward at point 1, per kernel (eager)."""
    p = _point(1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out = {}
    for kt in KERNELS:
        terms = j_ds_terms(kt, JKP(jp["log_variance"], jp["log_lengthscales"]),
                           jp["z"], jp["x"], jp["xc"], jp["log_q"])
        out[kt] = np.array([float(t) for t in terms])
    return p, out


@pytest.mark.parametrize("kt", KERNELS)
def test_terms_match_jax_double_single(jax_double_single, kt):
    p, ref = jax_double_single
    ours, _ = _port_terms(kt, p)
    _within_bound(ours, ref[kt], per_term=False)


@pytest.mark.parametrize("kt", KERNELS)
def test_terms_and_grads_match_jax_fp64_at_rounded_point(kt):
    p = _rounded(_point(1))
    ours, g = _port_terms(kt, p, grad=True)
    ref, jg = _jax_fp64(kt, p)
    _within_bound(ours, ref)
    _grads_close(g, jg)


@pytest.mark.parametrize("tensor_scale", [False, True])
def test_mask_and_gram_scale(tensor_scale):
    """The padded-transition mask and the minibatch gram scale 2.5 (a
    tensor in a masked window, elbo.py:144) enter as in
    ds_collapse.py:223-230."""
    p = _rounded(_point(4))
    mask = (np.arange(N) < N - 10).astype(np.float64)
    scale = torch.tensor(2.5) if tensor_scale else 2.5
    ours, g = _port_terms("SquaredExponential", p, torch.tensor(mask),
                          scale, grad=True)
    ref, jg = _jax_fp64("SquaredExponential", p, mask, 2.5)
    _within_bound(ours, ref)
    _grads_close(g, jg)
    unmasked, _ = _port_terms("SquaredExponential", p, gram_scale=scale)
    assert not np.allclose(unmasked, ours)


def test_inputs_rounded_to_fp32_and_outputs_fp32():
    """The segment evaluates at the float32 values of its inputs: fp64
    inputs and their float32 roundings give the same terms, float32 out;
    ``refine`` has no effect."""
    p = _point(3)
    kt = "SquaredExponential"
    full, _ = _port_terms(kt, p)
    r32 = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    terms = ds_collapsed_terms(
        kt, KernelParams(r32["log_variance"], r32["log_lengthscales"]),
        r32["z"], r32["x"], r32["xc"], r32["log_q"], refine=2)
    assert all(t.dtype == torch.float32 for t in terms)
    np.testing.assert_array_equal(np.array([float(t) for t in terms]), full)
    again, _ = _port_terms(kt, p, refine=0)
    np.testing.assert_array_equal(again, full)


def _port_u_posterior(p):
    t = {k: torch.tensor(v) for k, v in p.items()}
    um, qs = ds_collapsed_u_posterior(
        "SquaredExponential",
        KernelParams(t["log_variance"], t["log_lengthscales"]), t["z"],
        t["x"], t["xc"], t["log_q"])
    assert um.dtype == qs.dtype == torch.float32
    return um.numpy().astype(np.float64), qs.numpy().astype(np.float64)


def _jax_u_posterior(p):
    kp = JKP(jnp.asarray(p["log_variance"]), jnp.asarray(p["log_lengthscales"]))
    z = jnp.asarray(p["z"])
    pre = jcond.kernel_precal("SquaredExponential", kp, z)
    um, qs = jcond.collapsed_u_posterior(
        "SquaredExponential", kp, pre, z, jnp.asarray(p["x"]),
        jnp.asarray(p["xc"]), jnp.exp(jnp.asarray(p["log_q"])))
    return np.asarray(um), np.asarray(qs)


def test_u_posterior_matches_fp64():
    p = _point(9)
    um, qs = _port_u_posterior(p)
    um64, qs64 = _jax_u_posterior(p)
    assert um.shape == um64.shape == (M, D) and qs.shape == qs64.shape
    np.testing.assert_allclose(um, um64, rtol=0, atol=2e-6)
    np.testing.assert_allclose(qs, qs64, rtol=0, atol=2e-6)


def test_u_posterior_sharp_q_beats_fp32():
    """Q ≈ 2.3e-6 makes cond(H) ~ ‖F̃‖²/Q: the port's fp32 native q(U)
    degrades, the float64 segment stays at fp64 (ds_collapse.py:169-172)."""
    p = _point(10, log_q=-13.0)
    um64, qs64 = _jax_u_posterior(p)
    um, qs = _port_u_posterior(p)
    t32 = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    kp32 = KernelParams(t32["log_variance"], t32["log_lengthscales"])
    pre32 = cond.kernel_precal("SquaredExponential", kp32, t32["z"])
    um32, qs32 = cond.collapsed_u_posterior(
        "SquaredExponential", kp32, pre32, t32["z"], t32["x"], t32["xc"],
        torch.exp(t32["log_q"]))
    err32 = np.abs(qs32.double().numpy() - qs64).max()
    errds = np.abs(qs - qs64).max()
    assert errds < 0.1 * err32, (errds, err32)
    merr32 = np.abs(um32.double().numpy() - um64).max()
    merrds = np.abs(um - um64).max()
    assert merrds < 0.5 * merr32, (merrds, merr32)


def test_ds_precal_matches_fp64():
    p = _point(11)
    t = {k: torch.tensor(v) for k, v in p.items()}
    pre = ds_precal("SquaredExponential",
                    KernelParams(t["log_variance"], t["log_lengthscales"]),
                    t["z"])
    assert pre.lm.dtype == pre.lm_inv.dtype == torch.float32
    kp = JKP(jnp.asarray(p["log_variance"]), jnp.asarray(p["log_lengthscales"]))
    p64 = jcond.kernel_precal("SquaredExponential", kp, jnp.asarray(p["z"]))
    np.testing.assert_allclose(pre.lm.double().numpy(), np.asarray(p64.lm),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pre.lm_inv.double().numpy(),
                               np.asarray(p64.lm_inv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_harsh_point_values_and_grads_finite(dtype):
    """lv=8, ls=6: Kmm ≈ e⁸·𝟙𝟙ᵀ + jitter, numerically rank one, past the
    fp32 Cholesky's reach (tests/test_ds_collapse.py:140-187); fp32 leaves
    as on the card, fp64 as in a CPU run."""
    p = _point(5, ls=6.0, lv=8.0)
    t = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
         for k, v in p.items()}
    terms = ds_collapsed_terms(
        "SquaredExponential",
        KernelParams(t["log_variance"], t["log_lengthscales"]), t["z"],
        t["x"], t["xc"], t["log_q"])
    assert all(bool(torch.isfinite(v)) for v in terms)
    grads = torch.autograd.grad(sum(terms), [t[k] for k in GRADS])
    assert all(g.dtype == dtype and bool(torch.isfinite(g).all())
               for g in grads)

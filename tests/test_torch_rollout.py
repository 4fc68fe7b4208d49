"""Port parity (e), rollout: the plain rollout against the JAX recursion and
against the Pallas kernel, and the port's random numbers.

- ``rollout_reference`` against ``ffvd_tpu/eval/rollout.py::_rollout_one``,
  fed the normals JAX draws itself, over T=30 on the ballbeam warm start:
  fp64, rtol 1e-10 (the two differ in summation order only).
- ``rollout_reference`` in fp32 with zero noise against ``pallas_rollout``
  in interpret mode, at tests/test_pallas_rollout.py's tolerances (rtol 2e-4,
  atol 2e-5): this holds the port against the TPU kernel itself.
- Philox4x32-10 against the Random123 known-answer vectors, and the
  Box-Muller transform against JAX's and by its moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.eval.rollout import _rollout_one
from ffvd_tpu.model.conditionals import collapsed_u_posterior as j_collapse
from ffvd_tpu.model.conditionals import kernel_precal as j_precal
from ffvd_tpu.model.params import init_params_from_warmstart as j_init
from ffvd_tpu.ops.kernels import KernelParams as JKP
from ffvd_tpu.ops.pallas_rollout import bits_to_normal as j_bits_to_normal
from ffvd_tpu.ops.pallas_rollout import pallas_rollout

from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.ops.kernels import KernelParams

torch.set_num_threads(1)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _ballbeam_inputs(t_len):
    """JAX-side rollout inputs at the ballbeam warm start, as numpy."""
    p = j_init(j_load_warmstart("ballbeam"))
    ds = j_create_dataset("ballbeam")
    n = p.n_transitions
    control = jnp.asarray(ds.control)
    xc = jnp.concatenate([p.x[:n], control[:n]], axis=1)
    pre = jax.jit(j_precal, static_argnums=0)("SquaredExponential",
                                              p.kernel, p.z)
    u_val, q_sqrt = jax.jit(j_collapse, static_argnums=0)(
        "SquaredExponential", p.kernel, pre, p.z, p.x, xc, p.q)
    return dict(lv=p.kernel.log_variance, ls=p.kernel.log_lengthscales,
                z=p.z, u=u_val, q_sqrt=q_sqrt, q=p.q, x0=p.x[-1],
                controls=control[n:n + t_len])


@pytest.mark.parametrize("with_qsqrt", [True, False])
def test_reference_matches_jax_rollout_one(with_qsqrt):
    t_len, d = 30, 4
    inp = _ballbeam_inputs(t_len)
    key = jax.random.key(3)
    q_sqrt = inp["q_sqrt"] if with_qsqrt else None
    roll = jax.jit(_rollout_one, static_argnums=(0, 1))
    jxs, jvs = roll("SquaredExponential", 1e-5,
                    JKP(inp["lv"], inp["ls"]), inp["z"], inp["u"], q_sqrt,
                    inp["q"], inp["x0"], inp["controls"], key)
    # the normals _rollout_one draws: normal(split(key, T)[t], (D,))
    noise = jax.jit(jax.vmap(lambda k: jax.random.normal(
        k, (d,), jnp.float64)))(jax.random.split(key, t_len))

    kp = KernelParams(_t(inp["lv"]), _t(inp["ls"]))
    pre = kernel_precal("SquaredExponential", kp, _t(inp["z"]))
    xs, vs = ro.rollout_reference(
        kp, _t(inp["z"]), pre.lm_inv, _t(inp["u"]),
        _t(q_sqrt) if with_qsqrt else None, _t(inp["q"]), _t(inp["x0"]),
        _t(inp["controls"]), 1, noise=_t(noise)[None])
    np.testing.assert_allclose(xs[0].numpy(), np.asarray(jxs), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(vs[0].numpy(), np.asarray(jvs), rtol=1e-10,
                               atol=1e-14)


def _small_model(rng, n=12, m=8, d=2, u_dim=1):
    din = d + u_dim
    return dict(x=0.5 * rng.randn(n + 1, d), u=rng.randn(m, d),
                z=rng.randn(m, din), lv=np.log(rng.rand(d) + 0.2),
                ls=np.log(rng.rand(d, din) + 0.5),
                q=rng.rand(d) * 0.2 + 0.05, control=rng.randn(2 * n, u_dim))


@pytest.mark.parametrize("with_qsqrt,u_dim", [(False, 1), (True, 1),
                                              (True, 0)])
def test_reference_matches_pallas_kernel_zero_noise(with_qsqrt, u_dim):
    """fp32, zero noise, three samples, as tests/test_pallas_rollout.py runs
    the Pallas kernel (interpret mode); U=0 takes its zero-column padding."""
    rng = np.random.RandomState(11)
    mdl = _small_model(rng, u_dim=u_dim)
    f32 = np.float32
    jkp = JKP(jnp.asarray(mdl["lv"], f32), jnp.asarray(mdl["ls"], f32))
    jz = jnp.asarray(mdl["z"], f32)
    lm_inv = jax.jit(j_precal, static_argnums=0)("SquaredExponential", jkp,
                                                 jz, 1e-5).lm_inv
    q_sqrt = (np.stack([np.triu(rng.rand(8, 8) * 0.2 + 0.05 * np.eye(8))
                        for _ in range(2)]).astype(f32)
              if with_qsqrt else None)
    controls = mdl["control"][:7].astype(f32)
    x0 = mdl["x"][-1].astype(f32)
    xs_p, vs_p = pallas_rollout(
        jkp, jz, lm_inv, jnp.asarray(mdl["u"], f32),
        None if q_sqrt is None else jnp.asarray(q_sqrt),
        jnp.asarray(mdl["q"], f32), jnp.asarray(x0), jnp.asarray(controls),
        seed=0, num_samples=3, zero_noise=True, interpret=True)

    t32 = lambda a: _t(a, torch.float32)
    xs, vs = ro.rollout_reference(
        KernelParams(t32(mdl["lv"]), t32(mdl["ls"])), t32(mdl["z"]),
        t32(lm_inv), t32(mdl["u"]), None if q_sqrt is None else t32(q_sqrt),
        t32(mdl["q"]), t32(x0), t32(controls).reshape(7, u_dim), 3,
        noise=torch.zeros((3, 7, 2)))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_p), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(vs.numpy(), np.asarray(vs_p), rtol=2e-4,
                               atol=2e-5)


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in cases:
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        got = ro.philox4x32(*c, key[0] | (key[1] << 32))
        assert tuple(int(g) for g in got) == want


def test_bits_to_normal_matches_jax_and_is_standard_normal():
    rng = np.random.RandomState(11)
    n = 200_000
    b1 = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    b2 = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    z = ro.bits_to_normal(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    jz = np.asarray(jax.jit(j_bits_to_normal)(jnp.asarray(b1),
                                              jnp.asarray(b2)))
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5)
    assert abs(z.mean()) < 0.01
    np.testing.assert_allclose(z.std(), 1.0, rtol=0.01)
    np.testing.assert_allclose(np.mean(np.abs(z) > 2), 0.0455, rtol=0.1)


def test_philox_normals_moments_and_counters():
    z = ro.philox_normals(1234, (64, 128, 4), torch.float64)
    assert z.shape == (64, 128, 4)
    flat = z.reshape(-1)
    assert abs(float(flat.mean())) < 0.01
    assert abs(float(flat.std()) - 1.0) < 0.01
    # counter (s, t, d): a sub-block is the same draw at the same counters
    np.testing.assert_array_equal(
        ro.philox_normals(1234, (3, 5, 2), torch.float64).numpy(),
        z[:3, :5, :2].numpy())
    assert not torch.equal(ro.philox_normals(1235, (3, 5, 2)),
                           ro.philox_normals(1234, (3, 5, 2)))


def _tiny(dtype=torch.float64):
    rng = np.random.RandomState(2)
    mdl = _small_model(rng)
    kp = KernelParams(_t(mdl["lv"], dtype), _t(mdl["ls"], dtype))
    z = _t(mdl["z"], dtype)
    pre = kernel_precal("SquaredExponential", kp, z)
    return (kp, z, pre.lm_inv, _t(mdl["u"], dtype), None, _t(mdl["q"], dtype),
            _t(mdl["x"][-1], dtype), _t(mdl["control"][:9], dtype))


def test_cpu_rollout_is_the_reference_and_launches_nothing():
    args = _tiny()
    before = ro.rollout.launches
    xs, vs = ro.rollout(*args, 4, generator=torch.Generator().manual_seed(5))
    xr, vr = ro.rollout_reference(*args, 4,
                                  generator=torch.Generator().manual_seed(5))
    assert ro.rollout.launches == before
    assert torch.equal(xs, xr) and torch.equal(vs, vr)
    assert xs.shape == (4, 9, 2) and bool((vs >= 0).all())
    # the drawn noise is the Philox stream of the generator's seed
    seed = ro.draw_seed(torch.Generator().manual_seed(5))
    xn, _ = ro.rollout_reference(
        *args, 4, noise=ro.philox_normals(seed, (4, 9, 2), torch.float64))
    assert torch.equal(xs, xn)


def test_rollout_rejects_bad_inputs():
    kp, z, lm_inv, u, _, q, x0, ctrl = _tiny()
    with pytest.raises(ValueError, match="u_val"):
        ro.rollout(kp, z, lm_inv, u[:, :1], None, q, x0, ctrl, 2)
    with pytest.raises(ValueError, match="noise"):
        ro.rollout(kp, z, lm_inv, u, None, q, x0, ctrl, 2,
                   noise=torch.zeros(2, 3, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="q is torch.float32"):
        ro.rollout(kp, z, lm_inv, u, None, q.float(), x0, ctrl, 2)
    with pytest.raises(ValueError, match="input columns"):
        ro.rollout(kp, z, lm_inv, u, None, q, x0, ctrl[:, :0], 2)
    with pytest.raises(ValueError, match="ffvd_normals is a CUDA kernel"):
        ro.ffvd_normals(1, 8, device="cpu")

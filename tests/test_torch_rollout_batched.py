"""The rollout with per-sample parameters (``rollout_batched``), on the CPU.

- A batched call whose samples all carry the same parameters equals the
  shared ``rollout_reference`` bit for bit, with given noise and with the
  in-kernel Philox stream (counter (s, t, d) in both).
- Each sample of a batched call with distinct parameters equals
  ``ffvd_tpu/eval/rollout.py::_rollout_one`` for its own parameters, fed
  the normals JAX draws: fp64, rtol 1e-10 (summation order only).
- The kernel's per-sample inputs: strides are each sample's slice size,
  0 for a shared call, and the packed slices are the shared packing of
  each sample's own factors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.eval.rollout import _rollout_one
from ffvd_tpu.model.conditionals import collapsed_u_posterior as j_collapse
from ffvd_tpu.model.conditionals import kernel_precal as j_precal
from ffvd_tpu.ops.kernels import KernelParams as JKP

from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.ops.kernels import KernelParams

torch.set_num_threads(1)


def _model(rng, n=12, m=8, d=2, u_dim=1):
    din = d + u_dim
    return dict(x=0.5 * rng.randn(n + 1, d), u=rng.randn(m, d),
                z=rng.randn(m, din), lv=np.log(rng.rand(d) + 0.2),
                ls=np.log(rng.rand(d, din) + 0.5),
                q=rng.rand(d) * 0.2 + 0.05, control=rng.randn(2 * n, u_dim))


def _collapse(mdl):
    """JAX's collapsed q(U) for a model (q_sqrt upper), as numpy."""
    kp = JKP(jnp.asarray(mdl["lv"]), jnp.asarray(mdl["ls"]))
    z = jnp.asarray(mdl["z"])
    n = mdl["x"].shape[0] - 1
    xc = jnp.concatenate([jnp.asarray(mdl["x"][:n]),
                          jnp.asarray(mdl["control"][:n])], axis=1)
    pre = jax.jit(j_precal, static_argnums=0)("SquaredExponential", kp, z)
    u, q_sqrt = jax.jit(j_collapse, static_argnums=0)(
        "SquaredExponential", kp, pre, z, jnp.asarray(mdl["x"]), xc,
        jnp.asarray(mdl["q"]))
    return np.asarray(u), np.asarray(q_sqrt)


def _samples(seed, s=3):
    """S distinct parameter sets: one model perturbed per sample."""
    rng = np.random.RandomState(seed)
    base = _model(rng)
    out = []
    for _ in range(s):
        mdl = dict(base)
        mdl["lv"] = base["lv"] + 0.2 * rng.randn(*base["lv"].shape)
        mdl["ls"] = base["ls"] + 0.1 * rng.randn(*base["ls"].shape)
        mdl["z"] = base["z"] + 0.05 * rng.randn(*base["z"].shape)
        mdl["q"] = base["q"] * np.exp(0.3 * rng.randn(*base["q"].shape))
        mdl["x"] = base["x"] + 0.1 * rng.randn(*base["x"].shape)
        mdl["u"], mdl["q_sqrt"] = _collapse(mdl)
        out.append(mdl)
    return out


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _batched_args(samples, with_q):
    kp = KernelParams(_t([s["lv"] for s in samples]),
                      _t([s["ls"] for s in samples]))
    z = _t([s["z"] for s in samples])
    lm_inv = torch.stack([kernel_precal(
        "SquaredExponential", KernelParams(_t(s["lv"]), _t(s["ls"])),
        _t(s["z"])).lm_inv for s in samples])
    return dict(kparams=kp, z=z, lm_inv=lm_inv,
                u_val=_t([s["u"] for s in samples]),
                q_sqrt=_t([s["q_sqrt"] for s in samples]) if with_q else None,
                q=_t([s["q"] for s in samples]),
                x0=_t([s["x"][-1] for s in samples]))


@pytest.mark.parametrize("with_q", [True, False])
def test_each_sample_matches_jax_rollout_one(with_q):
    samples = _samples(3)
    t_len, d = 9, 2
    controls = samples[0]["control"][:t_len]
    keys = jax.random.split(jax.random.key(11), len(samples))
    roll = jax.jit(_rollout_one, static_argnums=(0, 1))
    draw = jax.jit(jax.vmap(lambda k: jax.vmap(lambda kt: jax.random.normal(
        kt, (d,), jnp.float64))(jax.random.split(k, t_len))))
    noise = np.asarray(draw(keys))
    args = _batched_args(samples, with_q)
    xs, vs = ro.rollout_batched(**args, controls=_t(controls),
                                noise=_t(noise))
    assert xs.shape == (3, t_len, d)
    for i, (mdl, key) in enumerate(zip(samples, keys)):
        jxs, jvs = roll("SquaredExponential", 1e-5,
                        JKP(jnp.asarray(mdl["lv"]), jnp.asarray(mdl["ls"])),
                        jnp.asarray(mdl["z"]), jnp.asarray(mdl["u"]),
                        jnp.asarray(mdl["q_sqrt"]) if with_q else None,
                        jnp.asarray(mdl["q"]), jnp.asarray(mdl["x"][-1]),
                        jnp.asarray(controls), key)
        np.testing.assert_allclose(xs[i].numpy(), np.asarray(jxs),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(vs[i].numpy(), np.asarray(jvs),
                                   rtol=1e-10, atol=1e-14)
    # the samples really differ
    assert not torch.allclose(xs[0], xs[1])


@pytest.mark.parametrize("noise_kind", ["given", "philox"])
@pytest.mark.parametrize("with_q", [True, False])
def test_identical_samples_equal_the_shared_call_bit_for_bit(noise_kind,
                                                             with_q):
    mdl = _samples(4, s=1)[0]
    s, t_len = 5, 12
    shared = _batched_args([mdl], with_q)
    shared = {k: None if v is None else
              (KernelParams(v.log_variance[0], v.log_lengthscales[0])
               if k == "kparams" else v[0]) for k, v in shared.items()}
    rep = lambda t: t[None].expand((s,) + t.shape).clone()
    batched = {k: None if v is None else
               (KernelParams(rep(v.log_variance), rep(v.log_lengthscales))
                if k == "kparams" else rep(v)) for k, v in shared.items()}
    controls = _t(mdl["control"][:t_len])
    if noise_kind == "given":
        kw = lambda: dict(noise=_t(np.random.RandomState(0).randn(s, t_len,
                                                                   2)))
    else:
        kw = lambda: dict(generator=torch.Generator().manual_seed(9))
    xs, vs = ro.rollout_reference(
        shared["kparams"], shared["z"], shared["lm_inv"], shared["u_val"],
        shared["q_sqrt"], shared["q"], shared["x0"], controls, s, **kw())
    xb, vb = ro.rollout_reference_batched(controls=controls, **batched,
                                          **kw())
    assert torch.equal(xs, xb) and torch.equal(vs, vb)
    xw, vw = ro.rollout_batched(controls=controls, **batched, **kw())
    assert torch.equal(xs, xw) and torch.equal(vs, vw)


def test_cpu_batched_rollout_launches_nothing_and_checks_shapes():
    args = _batched_args(_samples(5), True)
    controls = _t(np.zeros((4, 1)))
    before = ro.rollout.launches
    xs, _ = ro.rollout_batched(**args, controls=controls,
                               generator=torch.Generator().manual_seed(1))
    assert ro.rollout.launches == before and xs.shape == (3, 4, 2)
    bad = dict(args, u_val=args["u_val"][:2])
    with pytest.raises(ValueError, match="u_val"):
        ro.rollout_batched(**bad, controls=controls)
    bad = dict(args, kparams=KernelParams(args["kparams"].log_variance[0],
                                          args["kparams"].log_lengthscales))
    with pytest.raises(ValueError, match="log_variance"):
        ro.rollout_batched(**bad, controls=controls)
    with pytest.raises(ValueError, match="noise"):
        ro.rollout_batched(**args, controls=controls,
                           noise=torch.zeros(3, 5, 2, dtype=torch.float64))


def test_kernel_inputs_per_sample_strides_and_packing():
    samples = _samples(6)
    args = _batched_args(samples, True)
    controls = _t(np.zeros((4, 1)))
    kin = ro.kernel_inputs(args["kparams"], args["z"], args["lm_inv"],
                           args["u_val"], args["q_sqrt"], args["q"],
                           args["x0"], controls, 3, batched=True)
    d, m, din, p = 2, 8, 3, 36
    assert kin["lp"].shape == (3, d, p) and kin["qp"].shape == (3, d, p)
    assert ro.sample_strides(kin, True) == (d * m * din, d * din, d, d * p,
                                            m * d, d, d * p)
    for i in range(3):
        one = ro.kernel_inputs(
            KernelParams(args["kparams"].log_variance[i],
                         args["kparams"].log_lengthscales[i]),
            args["z"][i], args["lm_inv"][i], args["u_val"][i],
            args["q_sqrt"][i], args["q"][i], args["x0"][i], controls, 1)
        assert ro.sample_strides(one, False) == (0,) * 7
        for k in ro.STRIDED:
            assert torch.equal(kin[k][i], one[k]), k
        assert torch.equal(kin["x0"][i], one["x0"][0])
    no_q = ro.kernel_inputs(args["kparams"], args["z"], args["lm_inv"],
                            args["u_val"], None, args["q"], args["x0"],
                            controls, 3, batched=True)
    assert ro.sample_strides(no_q, True)[-1] == 0

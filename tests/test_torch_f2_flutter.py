"""F2: the port's float64 segment on flutter, held against the JAX
package's own double-single segment and its float64 objective at trained
points (ROADMAP Queue 3, F2).

``tests/golden_torch/f2_flutter_check.py`` trained flutter C4 (seed 1,
the vendored warm start) in the port under ``collapse_precision="ds64"``
and kept its float32 leaves every 1000 iterations; at the warm start and
at two kept states it took the gradient of the JAX package's ds64
objective (``ffvd_tpu/model/ds_collapse.py``, ``jax_enable_x64`` off as in
production) and of its float64 objective, and committed both with the
leaves (``tests/golden_torch/f2_flutter_states.npz``).  JAX's
double-single gradient takes minutes to jit on the CPU, so it is read
from that file; the float64 one is taken here again.

The float64 gradient itself is only as exact as H = AAᵀ/Q + I is
conditioned: two float64 evaluations that sum in another order may part
by cond(H)·2⁻⁵² relative.  JAX's double-single values are ≈49-bit, but
its gradient is their derivative taken in float32 arithmetic, and its
Cholesky returns the float32 seed where refinement would diverge
(``ffvd_tpu/ops/ds64.py::chol_and_inv``); both errors grow with cond(H)
(4.4e2 at the warm start, 1.1e10 and 4.9e10 at the two trained states,
where Q has fallen to ~1e-6).  So:

- the port's float64 gradient equals JAX's (taken here, and the file's)
  within max(1e-12, cond(H)·2⁻⁵²) in norm;
- at the warm start the port's ds64 gradient is the float64 gradient and
  JAX's ds64 gradient within 4e-6·max(|g|, 1) elementwise (the 4e-6 of
  ``tests/test_ds_collapse.py:117,249``);
- at every point the port's ds64 gradient is nearer the float64 one than
  the port's native float32 gradient is, and at the trained points also
  nearer than JAX's ds64 gradient, which there degrades towards float32.
"""

import json

import numpy as np
import pytest
import torch

from tests.golden_torch import f2_flutter_check as f2

torch.set_num_threads(2)

TOL = 4e-6
GUARD = 0.25
FIXTURE = np.load(f2.STATES)
POINTS = sorted({int(k.split("/")[0][2:]) for k in FIXTURE.files})
RECORD = json.loads(f2.OUT.read_text())


def _leaves(it):
    return {k: FIXTURE[f"it{it}/{k}"] for k in f2.LEAF_ORDER}


def _jax(it, name):
    return {k: FIXTURE[f"it{it}/{name}/{k}"] for k in f2.TRAINED}


def _wide(leaves):
    return {k: v.astype(np.float64) for k, v in leaves.items()}


def _elem(g, ref):
    return max(float((np.abs(g[k] - ref[k])
                      / np.maximum(np.abs(ref[k]), 1.0)).max())
               for k in f2.TRAINED)


def _cond(it):
    return max(RECORD["gradients"][str(it)]["jax_ds64_guard"]["cond_h"])


def test_fixture_points():
    """The warm start and two trained states with float32 leaves; at the
    trained ones Q is below 1e-5 and H beyond float32's reach (cond(H)·2⁻²⁴
    above the guard's 0.25)."""
    assert POINTS[0] == 0 and len(POINTS) == 3
    for it in POINTS:
        assert all(v.dtype == np.float32 for v in _leaves(it).values())
    for it in POINTS[1:]:
        assert RECORD["gradients"][str(it)]["max_Q"] < 1e-5
        assert _cond(it) * 2.0 ** -24 > GUARD


@pytest.mark.parametrize("it", POINTS)
def test_port_fp64_gradient_matches_jax_fp64(it):
    """The float64 gradients at the float32 point: JAX's taken here is the
    file's, and the port's is JAX's, within max(1e-12, cond(H)·2⁻⁵²) in
    norm."""
    tol = max(1e-12, _cond(it) * 2.0 ** -52)
    lv = _wide(_leaves(it))
    ref = _jax(it, "jax_fp64")
    assert f2.distance(f2.jax_grad(lv, "native"), ref)["rel_norm"] <= tol
    assert f2.distance(f2.port_grad(lv, "native"), ref)["rel_norm"] <= tol


@pytest.mark.parametrize("it", POINTS)
def test_port_ds64_gradient_against_fp64_and_jax_ds64(it):
    """The port's ds64 gradient: within 4e-6 of the float64 gradient and of
    JAX's ds64 gradient at the warm start; nearer the float64 gradient
    than the native float32 one everywhere, and than JAX's ds64 at the
    trained points."""
    g = f2.port_grad(_leaves(it), "ds64")
    fp64, jds = _jax(it, "jax_fp64"), _jax(it, "jax_ds64")
    near = f2.distance(g, fp64)["rel_norm"]
    fp32 = f2.port_grad(_leaves(it), "native", torch.float32)
    assert near < f2.distance(fp32, fp64)["rel_norm"]
    if it == 0:
        assert _elem(g, fp64) <= TOL
        assert _elem(g, jds) <= TOL
    else:
        assert near < f2.distance(jds, fp64)["rel_norm"]


def test_record_states_the_four_trajectories():
    """``f2_flutter_check.json``: the four trajectories with their
    checkpoints, the common length, the first partings, and a gradient
    record at the warm start and at every kept state."""
    tr = RECORD["trajectories"]
    assert sorted(tr) == sorted(f2.KINDS)
    assert RECORD["common_length"] == min(t["iterations"]
                                          for t in tr.values()) > 0
    assert all(t["checkpoints"] for t in tr.values())
    assert len(RECORD["first_parting"]) == 4
    assert {str(it) for it in POINTS} <= set(RECORD["gradients"])

"""Port parity, the mesh half of ``parallel/`` without processes.

- ``mesh_shape`` against JAX's ``make_mesh(n, ep, x_dim).shape`` on the
  conftest's 8 virtual CPU devices;
- ``multihost_mesh``'s single-node delegation and its errors against
  JAX's ``multihost_mesh``, and its multi-node errors, with the process
  group stubbed;
- ``initialize_multihost``: a no-op without the launcher's variables, a
  pass-through to ``init_process_group`` with them
  (``tests/test_sharding.py:129-162``);
- ``params_pspec`` / ``state_pspec`` against JAX's, leaf by leaf;
- ``shard_chain_state``: every process's share, put back together, is the
  whole state exactly; ``dim_split`` covers the dims;
- the rollout's Philox ``row_offset``: an offset draw (and an offset plain
  rollout) is the matching rows of the whole one, bit for bit.

The sharded runs themselves, on 4 gloo processes: tests/test_torch_dist_*.py.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.parallel import distributed as jdist
from ffvd_tpu.parallel.sharding import MultiChainTrainer as JMultiChain
from ffvd_tpu.parallel.sharding import make_mesh as j_make_mesh
from ffvd_tpu.parallel.sharding import params_pspec as j_params_pspec
from ffvd_tpu.parallel.sharding import state_pspec as j_state_pspec

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.trainer import Trainer, grads_of
from ffvd_tpu_torch.model.params import (LEAF_PATHS, GPSSMParams, SSMData,
                                         hidden_paths, params_from_numpy)
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.parallel import distributed as pdist
from ffvd_tpu_torch.parallel.sharding import (EP_AXIS, MultiChainTrainer,
                                              dim_split, mesh_shape,
                                              params_pspec,
                                              shard_chain_state, state_pspec)
from ffvd_tpu_torch.parallel.sequence import RowShareTrainer
from tests.test_torch_deep import deep_model, jax_deep_params

torch.set_num_threads(2)


def jax_specs(tree):
    """A JAX pspec tree's leaves as tuples, keyed by the port's paths."""
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))
    paths = LEAF_PATHS + hidden_paths(len(tree.hidden))
    return dict(zip(paths, map(tuple, leaves)))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("x_dim", [2, 4, 6])
def test_mesh_shape_is_jax_make_mesh(n, x_dim):
    jshape = j_make_mesh(n, x_dim=x_dim).shape
    assert mesh_shape(n, x_dim=x_dim) == (jshape["dp"], jshape["ep"])
    for ep in (1, 2):
        if n % ep == 0:
            js = j_make_mesh(n, ep=ep, x_dim=x_dim).shape
            assert mesh_shape(n, ep, x_dim) == (js["dp"], js["ep"])
    with pytest.raises(ValueError, match="does not divide"):
        mesh_shape(n, ep=3 if n % 3 else 5, x_dim=x_dim)


@pytest.fixture
def group_of(monkeypatch):
    """Stub a started group of ``n`` processes (``LOCAL_WORLD_SIZE`` per
    node); the mesh builder records the shape it would build."""
    built = []

    def stub(n, n_local=None):
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: n)
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
        monkeypatch.setattr(
            "torch.distributed.device_mesh.init_device_mesh",
            lambda dev, shape, mesh_dim_names: built.append(
                (dev, tuple(shape), tuple(mesh_dim_names))) or tuple(shape))
        if n_local is None:
            monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n_local))
        return built
    return stub


@pytest.mark.parametrize("dp,ep,x_dim", [
    (None, None, 2), (None, None, 4), (None, 1, 4), (4, None, 2),
    (8, None, 4), (2, None, 6), (4, 2, 2), (2, 4, 6)])
def test_multihost_mesh_one_node_is_jax(group_of, dp, ep, x_dim):
    """One node: the shapes of JAX's single-process delegation (all 8
    devices: a port mesh takes every process)."""
    built = group_of(8)
    mesh = pdist.multihost_mesh(dp=dp, ep=ep, x_dim=x_dim)
    jshape = jdist.multihost_mesh(dp=dp, ep=ep, x_dim=x_dim).shape
    assert mesh == (jshape["dp"], jshape["ep"])
    assert built == [("cpu", mesh, ("dp", "ep"))]


def test_multihost_mesh_errors_are_jax(group_of):
    group_of(8)
    with pytest.raises(ValueError, match="dp=3 does not divide the "
                       "8-device platform") as port:
        pdist.multihost_mesh(dp=3)
    with pytest.raises(ValueError) as jax_err:
        jdist.multihost_mesh(dp=3)
    assert str(port.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="one process runs each device"):
        pdist.multihost_mesh(dp=2, ep=2, x_dim=2)   # JAX takes 4 of 8


def test_multihost_mesh_across_nodes(group_of):
    """Two nodes of 4: 'ep' within a node, 'dp' across; JAX's errors."""
    built = group_of(8, n_local=4)
    assert pdist.multihost_mesh(x_dim=4) == (2, 4)
    assert pdist.multihost_mesh(x_dim=2) == (4, 2)
    assert pdist.multihost_mesh(dp=4, ep=2) == (4, 2)
    assert [b[1] for b in built] == [(2, 4), (4, 2), (4, 2)]
    with pytest.raises(ValueError, match=r"ep=3 must divide the 4 local "
                       r"devices"):
        pdist.multihost_mesh(ep=3)
    with pytest.raises(ValueError, match=r"dp=3 inconsistent with 2 "
                       r"processes x 4 local devices / ep=2 \(need dp = 4\)"):
        pdist.multihost_mesh(dp=3, ep=2)


def test_initialize_multihost_single_process_noop(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            AssertionError("must not initialize")))
    assert pdist.initialize_multihost() is False


def test_initialize_multihost_passthrough(monkeypatch):
    calls = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pdist.initialize_multihost(device="cpu", timeout=30) is True
    assert calls["backend"] == "gloo"
    assert calls["init_method"] == "env://"
    assert (calls["world_size"], calls["rank"]) == (4, 2)
    assert calls["timeout"].total_seconds() == 30
    calls.clear()
    assert pdist.initialize_multihost("file://store", world_size=2, rank=1,
                                      backend="gloo", device="cpu") is True
    assert (calls["init_method"], calls["world_size"], calls["rank"]) == (
        "file://store", 2, 1)


@pytest.mark.parametrize("n_hidden", [0, 1, 2])
@pytest.mark.parametrize("chain_axis", [True, False])
def test_params_pspec_is_jax(n_hidden, chain_axis):
    assert params_pspec(chain_axis, n_hidden) == jax_specs(
        j_params_pspec(chain_axis, n_hidden))


def _stacked(c, d, seed=3):
    leaves, y, control = deep_model(seed, n=10, n_hidden=0, d=d)
    rng = np.random.RandomState(seed)
    stacked = {k: np.stack([v + 1e-3 * rng.randn(*v.shape)
                            for _ in range(c)]) for k, v in leaves.items()}
    return stacked, y, control


@pytest.mark.parametrize("case", [2, 4])
def test_state_pspec_is_jax(case):
    kw = dict(dataset="ballbeam", case=case, num_inducing=6, x_dim=2,
              window_size=4)
    leaves, y, control = _stacked(3, 2)
    jm = JMultiChain(JConfig(**kw), JSSMData(y=jax.numpy.asarray(y),
                                             control=jax.numpy.asarray(
                                                 control)), 3)
    jstate = jm.init_state(jax_deep_params(leaves))
    jspec = j_state_pspec(jstate)
    mct = MultiChainTrainer(FFVDConfig(**kw), SSMData(
        y=torch.as_tensor(y), control=torch.as_tensor(control)), 3)
    state = mct.init_state(params_from_numpy(leaves))
    spec = state_pspec(state)
    jparams = jax_specs(jspec.params)
    for k, v in jparams.items():
        assert spec[f"params.{k}"] == v, k
    for f in ("xi", "g", "g2", "p"):
        jf = jax_specs(getattr(jspec.sghmc, f))
        for k in mct.subset.paths:
            assert spec[f"sghmc.{f}.{k}"] == jf[k], (f, k)
    jwin = jax_specs(jspec.window)
    for k in mct.subset.paths:
        assert spec[f"window.{k}"] == jwin[k] == ("dp",), k
    # Adam's moments over 'dp' in both; JAX's per-chain step count is one
    # int in the port, replicated.
    jadam = {tuple(s) for s in jax.tree.leaves(
        jspec.adam, is_leaf=lambda x: isinstance(x, P))}
    assert jadam == {("dp",)}
    assert {v for k, v in spec.items() if k.startswith("adam.exp")} == {
        ("dp",)}
    assert spec["adam.step"] == spec["step"] == spec["window_count"] == ()


class FakeMesh:
    """The coordinates of one process of a ('dp', 'ep') mesh."""

    mesh_dim_names = ("dp", "ep")

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def get_local_rank(self, name):
        return self.coords[self.mesh_dim_names.index(name)]


@pytest.mark.parametrize("dp,ep,d", [(2, 2, 2), (2, 4, 6), (1, 4, 4),
                                     (4, 1, 2)])
def test_shards_put_back_together_are_the_state(dp, ep, d):
    """Every process's ``shard_chain_state`` — members over 'dp'; the
    per-dim leaves, their SG-HMC state, window and Adam moments over 'ep';
    the rest whole — concatenated back is the whole state, exactly."""
    c = 4
    leaves, y, control = _stacked(c, d)
    mct = MultiChainTrainer(FFVDConfig(dataset="ballbeam", case=2,
                                       num_inducing=6, x_dim=d,
                                       window_size=4),
                            SSMData(y=torch.as_tensor(y),
                                    control=torch.as_tensor(control)), c)
    state = mct.init_state(params_from_numpy(leaves))
    mct.run(state, 2, generator=torch.Generator().manual_seed(0))
    keys = state_pspec(state)
    from ffvd_tpu_torch.parallel.rank_jobs import _state_dict
    whole = _state_dict(state)
    assert set(whole) <= set(keys)
    shards = {(i, e): _state_dict(shard_chain_state(
        state, FakeMesh((dp, ep), (i, e)))) for i in range(dp)
        for e in range(ep)}
    for key, t in whole.items():
        path = key.split(".", 1)[1] if key.startswith(("params.", "window."))\
            else key.split(".", 2)[2]
        split_dims = path in EP_AXIS
        rows = []
        for i in range(dp):
            if split_dims:
                ax = t.dim() + EP_AXIS[path]
                rows.append(torch.cat([shards[i, e][key] for e in range(ep)],
                                      dim=ax))
            else:
                for e in range(1, ep):    # whole on every 'ep' process
                    assert torch.equal(shards[i, e][key], shards[i, 0][key])
                rows.append(shards[i, 0][key])
        assert torch.equal(torch.cat(rows), t), key
    assert [dim_split(d, ep, e) for e in range(ep)][-1][1] == d


def test_dim_split_covers_uneven_dims():
    assert [dim_split(6, 4, e) for e in range(4)] == [(0, 2), (2, 4), (4, 5),
                                                      (5, 6)]
    assert [dim_split(4, 2, e) for e in range(2)] == [(0, 2), (2, 4)]


def test_a_windowed_objective_is_not_split_over_sp():
    """Without a mesh ('sp' of one process, holding every row) the window
    is not split: the row-share trainer's windowed objective is the
    unsharded one, value and gradients, at every start.  Splits over 4
    processes: ``tests/test_torch_dist_window.py``."""
    leaves, y, control = deep_model(1, n=20, n_hidden=0)
    cfg = FFVDConfig(dataset="ballbeam", case=4, num_inducing=6, x_dim=2,
                     minibatch_size=8)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    share = RowShareTrainer(cfg, data, None)
    assert share.rows == (0, 20) and share.window_n == 8
    one = Trainer(cfg, data)
    for start in (0, 5, 12):
        got, want = [], []
        for tr, out in ((share, got), (one, want)):
            leaves_t = {k: torch.tensor(v, requires_grad=True)
                        for k, v in leaves.items()}
            nll = tr.train_nll(GPSSMParams.from_leaves(leaves_t),
                               start=torch.tensor([start]))
            out.append(nll.detach())
            out.extend(grads_of(nll, list(leaves_t.values())))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_philox_row_offset_draws_the_whole_launchs_rows(dtype):
    seed = 0x1234ABCD9876
    whole = ro.philox_normals(seed, (12, 7, 3), dtype)
    for r0, r1 in [(0, 5), (5, 12), (3, 4)]:
        part = ro.philox_normals(seed, (r1 - r0, 7, 3), dtype, row_offset=r0)
        assert torch.equal(part, whole[r0:r1])
    with pytest.raises(ValueError, match="32-bit row counter"):
        ro.philox_normals(seed, (2, 1, 1), dtype, row_offset=2 ** 32 - 1)


def test_offset_plain_rollout_is_the_whole_rollouts_rows():
    """The plain version of the kernel, per-sample inputs: rows [r0, r1)
    launched with ``row_offset=r0`` are rows r0..r1 of the whole launch,
    bit for bit (each row's arithmetic is independent of the others')."""
    g = torch.Generator().manual_seed(0)
    s, t_len, d, m, u = 8, 6, 2, 5, 1
    rnd = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    lm = torch.tril(rnd(s, d, m, m)) * 0.1 + torch.eye(m)
    inp = dict(kparams=ro.KernelParams(0.1 * rnd(s, d),
                                       0.1 * rnd(s, d, d + u)),
               z=rnd(s, m, d + u), lm_inv=lm, u_val=rnd(s, m, d),
               q_sqrt=torch.triu(0.1 * rnd(s, d, m, m)),
               q=0.01 + 0.1 * torch.rand(s, d, generator=g,
                                         dtype=torch.float64),
               x0=rnd(s, d))
    controls = rnd(t_len, u)
    seed_gen = lambda: torch.Generator().manual_seed(7)
    xs, vs = ro.rollout_batched(controls=controls, generator=seed_gen(),
                                **inp)
    for r0, r1 in [(0, 4), (4, 8), (2, 3)]:
        part = {k: (ro.KernelParams(v.log_variance[r0:r1],
                                    v.log_lengthscales[r0:r1])
                    if k == "kparams" else v[r0:r1]) for k, v in inp.items()}
        px, pv = ro.rollout_batched(controls=controls, generator=seed_gen(),
                                    row_offset=r0, **part)
        assert torch.equal(px, xs[r0:r1]) and torch.equal(pv, vs[r0:r1])

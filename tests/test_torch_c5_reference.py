"""The port's batched C5 training against the benchmark's plain reference of
C5 (``perfbench/reference/gpssm_sghmc.py``), on the CPU in float64 at a
small size: N=24 transitions, M=8 inducing points, D=2, two chains.

- ``MultiChainTrainer.run`` from a CPU generator, one call an iteration,
  follows the reference from the same seed within 1e-9: the nll trace, the
  Adam leaves' gradients as Adam received them, and every leaf after each
  iteration, the sampled kernel hypers included;
- the reference draws what the port draws, in the port's order: every
  sub-step's normals (``Trainer._sampler_normals``), then the window
  feed's integers (``Trainer._feed_params``);
- a float64 and a float32 run of the reference in one process each follow
  their own chain's draws.

It imports nothing of JAX: the reference is held to the port here, and the
port to the JAX package elsewhere (``test_torch_trainer_sghmc.py``)."""

import numpy as np
import pytest
import torch

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS
from ffvd_tpu_torch.model.params import SSMData, init_params_random
from ffvd_tpu_torch.parallel import MultiChainTrainer
from perfbench.reference import gpssm_sghmc as ref

torch.set_num_threads(2)

N, M, D, C, STEPS = 24, 8, 2, 2, 4
SEED = 2 ** 40 + 17
BETA1 = 0.9


def _trainer(jitter=1e-3):
    """A two-chain C5 trainer on made-up data and its state; with
    ``jitter`` 0 both chains start from the same leaves."""
    g = torch.Generator().manual_seed(5)
    y = torch.randn(N, 1, generator=g, dtype=torch.float64)
    ctrl = torch.randn(2 * N, 1, generator=g, dtype=torch.float64)
    p0 = init_params_random(N, D, M, 1, generator=g)
    mct = MultiChainTrainer(FFVDConfig(case=5, num_inducing=M, x_dim=D),
                            SSMData(y=y, control=ctrl), C)
    rng = np.random.default_rng(1)
    normals = {k: rng.standard_normal((C,) + tuple(v.shape)) * jitter / 1e-3
               for k, v in p0.leaves().items()}
    state = mct.init_state(mct.stack_params(p0, normals=normals))
    return mct, state, y, ctrl


def _leaves(state):
    return {k: v.detach().numpy().copy()
            for k, v in state.params.leaves().items()}


def _port_run(mct, state):
    """(the (STEPS, C) nll trace, each step's Adam gradients, the leaves
    after each step), one ``run`` call an iteration."""
    gen = torch.Generator().manual_seed(SEED)
    nlls, grads, after = [], [], []
    prev = None
    for _ in range(STEPS):
        nlls.append(mct.run(state, 1, generator=gen)[1].numpy())
        mom = {k: state.adam.state[p]["exp_avg"].detach().numpy().copy()
               for k, p in zip(state.adam_paths(),
                               state.adam.param_groups[0]["params"])}
        grads.append({k: (v - BETA1 * (0 if prev is None else prev[k]))
                      / (1 - BETA1) for k, v in mom.items()})
        prev = mom
        after.append(_leaves(state))
    return np.concatenate(nlls), grads, after


def _start(leaves, c, dtype=torch.float64):
    return ref.as_tensors(ref.with_draws({k: v[c] for k, v in leaves.items()},
                                         SEED, c, C),
                          dtype, "cpu", torch.float64)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def test_multichain_c5_follows_the_reference():
    mct, state, y, ctrl = _trainer()
    start = _leaves(state)
    nll, grads, after = _port_run(mct, state)
    for c in range(C):
        p = _start(start, c)
        r_nll, r_grads, _, _ = ref.train_steps(p, y, ctrl, STEPS, STEPS)
        _close(nll[:, c], r_nll.numpy(), 1e-9)
        assert set(r_grads[0]) == set(grads[0]) == set(ref.TRAINED)
        for t in range(STEPS):
            for k in ref.TRAINED:
                _close(grads[t][k][c], r_grads[t][k].numpy(), 1e-9)
            _, _, _, r_last = ref.train_steps(p, y, ctrl, t + 1)
            assert set(r_last) == set(after[t])
            for k, v in after[t].items():
                _close(v[c], r_last[k].numpy(), 1e-9)
        # the sampler moved the hypers, and Adam the rest
        for k in ref.SAMPLED + ref.TRAINED:
            assert not np.array_equal(after[-1][k][c], start[k][c]), k


@pytest.mark.parametrize("chains", [2, 3])
def test_reference_draws_in_the_ports_order(chains):
    g = torch.Generator().manual_seed(7)
    p0 = init_params_random(N, D, M, 1, generator=g)
    mct = MultiChainTrainer(FFVDConfig(case=5, num_inducing=M, x_dim=D),
                            SSMData(y=torch.zeros(N, 1, dtype=torch.float64),
                                    control=torch.zeros(2 * N, 1,
                                                        dtype=torch.float64)),
                            chains)
    state = mct.init_state(mct.stack_params(p0))
    # slot i of every window holds i: the feed's pick reads as its slot
    for k, w in state.window.items():
        w.copy_(torch.arange(w.shape[1], dtype=w.dtype).reshape(
            (1, -1) + (1,) * (w.dim() - 2)).expand_as(w))
    state.window_count = mct.cfg.window_size
    port = torch.Generator().manual_seed(SEED)
    # one reference generator a chain, each taking its chain's slice
    ours = [torch.Generator().manual_seed(SEED) for _ in range(chains)]
    sub = mct.subset.split(state.params)
    for _ in range(3):
        normals = mct._sampler_normals(sub, port, len(SUBSTEP_FLAGS))
        fed = mct._feed_params(state, port, None).leaves()
        for c, gen in enumerate(ours):
            mine, bits = ref._iteration_draws(
                gen, {k: v[c] for k, v in sub.items()},
                ref.Draws(SEED, c, chains, torch.float64))
            for k in ref.SAMPLED:
                np.testing.assert_array_equal(mine[k], normals[k][c])
                assert fed[k][c].min() == fed[k][c].max() == bits % 64


def test_truth_and_control_follow_their_chains():
    """Both chains start from the same leaves, so only their draws tell
    them apart: each run of the reference, float64 or float32, in any
    order in one process, lands on its own chain's hypers."""
    mct, state, y, ctrl = _trainer(jitter=0.0)
    start = _leaves(state)
    _, _, after = _port_run(mct, state)
    port = after[-1]
    gap = {k: np.max(np.abs(port[k][0] - port[k][1])) for k in ref.SAMPLED}
    assert min(gap.values()) > 1e-5
    runs = [(c, dtype) for dtype in (torch.float64, torch.float32)
            for c in range(C)]
    for c, dtype in runs + runs[::-1]:
        last = ref.train_steps(_start(start, c, dtype), y, ctrl, STEPS)[3]
        for k in ref.SAMPLED:
            off = np.max(np.abs(last[k].double().numpy() - port[k][c]))
            assert off < (1e-9 if dtype == torch.float64 else 1e-3 * gap[k])

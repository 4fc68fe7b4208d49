"""Port parity, the chain axis with random draws: C2, C5 and deep C4/C5
(``n_layers=2``) on a small model (D=2, M=6, N=32), 2 chains, 3 iterations
of ``MultiChainTrainer`` against JAX's, with JAX's per-chain draws injected
(key layout in tests/test_torch_multichain.py): trace, leaves, sampler
state and window at rtol 1e-9 (fp64).
"""

import pytest
import torch

from tests.test_torch_deep import D, M, deep_model
from tests.test_torch_multichain import (  # noqa: F401 (fixture)
    assert_state_matches, fallback_raises, jax_multichain, port_multichain,
    stack_leaves)

torch.set_num_threads(2)


SAMPLER_CASES = [
    dict(case=2, window_size=2), dict(case=5),
    dict(case=4, n_layers=2), dict(case=5, n_layers=2, window_size=2),
]


@pytest.mark.parametrize("kw", SAMPLER_CASES, ids=["C2", "C5", "deep-C4",
                                                   "deep-C5"])
def test_chains_with_injected_draws_match_jax(kw):
    n_hidden = kw.get("n_layers", 1) - 1
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, **kw)
    per = [deep_model(s, n=32, n_hidden=n_hidden) for s in (3, 4)]
    leaves = stack_leaves([p[0] for p in per])
    y, control = per[0][1], per[0][2]
    jstate, jtrace, draws = jax_multichain(kw, leaves, y, control, 3)
    mct, state, trace = port_multichain(kw, leaves, y, control, 3, draws)
    assert_state_matches(mct, state, trace, jstate, jtrace,
                         dict(rtol=1e-9, atol=1e-12))

"""Checkpoints of a run split over processes: one file, the whole state.

Four gloo processes on the CPU (``parallel.distributed.spawn_local``) run
``parallel/rank_jobs.py::checkpoint_job``, fp64, on dp=2 × ep=2 chains (C4,
and C5 whose generator is restored), ``MultiDatasetTrainer`` of drive and
gas_furnace on dp=2 × ep=2, and sp=4 (windowed C2, whose generator draws
the sampler noise, the feeds and the window starts):

- save → restore into a fresh state with another generator → resume is bit
  for bit the uninterrupted meshed run, and the directory holds one file a
  checkpoint (no temporary file);
- the meshed file restores into one process (the state restored there is
  the state the mesh restored, gathered, bit for bit), and a one-process
  file restores into the mesh alike; each then runs on as the other does,
  up to the order of the sums (rtol 1e-12 over 'ep', 1e-10 over 'sp', the
  tolerances of ``test_torch_dist_chains.py`` and
  ``test_torch_dist_sequence.py``);
- ranks whose generators differ raise at the first save.

JAX's counterpart hands orbax the global sharded state
(``ffvd_tpu/utils/checkpoint.py:31-80``); the layout of the port's file is
the one-process layout (``tests/test_torch_utils.py``).
"""

import numpy as np
import pytest
import torch

from ffvd_tpu_torch.parallel.distributed import spawn_local
from ffvd_tpu_torch.parallel.rank_jobs import (checkpoint_job, jobs_in_turn,
                                               raise_job)
from tests.test_torch_deep import deep_model

torch.set_num_threads(2)
CPU = torch.device("cpu")
KW = dict(dataset="ballbeam", num_inducing=6, window_size=4)
FIRST, ITERS = 2, 4
FILES = [f"ckpt_{FIRST:09d}.pt", f"ckpt_{ITERS:09d}.pt"]


def stacked(c, seed=3):
    leaves, y, control = deep_model(seed, n=20, n_hidden=0)
    rng = np.random.RandomState(seed + 7)
    return ({k: np.stack([v + 1e-3 * rng.randn(*v.shape) for _ in range(c)])
             for k, v in leaves.items()}, y, control)


def run_spec(kind):
    """(job kind of the uninterrupted run, its spec with the mesh)."""
    if kind in ("C4", "C5"):
        leaves, y, control = stacked(4)
        return "chains", dict(cfg=dict(KW, case=int(kind[1]), x_dim=2),
                              leaves=leaves, y=y, control=control,
                              iters=ITERS, seed=4, mesh=(2, 2))
    if kind == "datasets":
        return "datasets", dict(cfg=dict(case=4),
                                names=["drive", "gas_furnace"], iters=ITERS,
                                mesh=(2, 2))
    leaves, y, control = deep_model(2, n=15, n_hidden=0)
    return "sequence", dict(cfg=dict(KW, case=2, minibatch_size=5),
                            leaves=leaves, y=y, control=control, iters=ITERS,
                            seed=4, mesh=(4,), axis="sp")


def ck_spec(kind, spec, mode, directory, mesh=True):
    return dict(spec, trainer=kind, mode=mode, first=FIRST,
                dir=str(directory), **({} if mesh else {"mesh": None}))


def ranks(job, args, tmp_path):
    return spawn_local(job, 4, "gloo", "cpu", args=args, timeout=240,
                       tmpdir=str(tmp_path))


def assert_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def assert_close(got, want, rtol):
    np.testing.assert_allclose(got["trace"].numpy(), want["trace"].numpy(),
                               rtol=rtol, atol=1e-12, err_msg="trace")
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   rtol=rtol, atol=1e-12, err_msg=k)


KINDS = ["C4", "C5", "datasets", "sp"]
RTOL = {"C4": 1e-12, "C5": 1e-12, "datasets": 1e-12, "sp": 1e-10}


@pytest.fixture(scope="module", params=KINDS)
def runs(request, tmp_path_factory):
    """One set of 4 processes a kind: the uninterrupted meshed run, a
    meshed run through a checkpoint in directory "mesh", and a meshed
    restore of the one-process file in directory "one"; then, in this
    process, the one-process run through "one" (before the spawn) and the
    restore of the meshed file (after it)."""
    kind = request.param
    tmp = tmp_path_factory.mktemp(f"ck_{kind}")
    job, spec = run_spec(kind)
    one = checkpoint_job(CPU, ck_spec(job, spec, "resume", tmp / "one",
                                      mesh=False))
    plan = [("whole", job, spec),
            ("resume", "checkpoint", ck_spec(job, spec, "resume",
                                             tmp / "mesh")),
            ("restore", "checkpoint", ck_spec(job, spec, "restore",
                                              tmp / "one"))]
    out = [{k: v[0] for k, v in r.items()}
           for r in ranks(jobs_in_turn, (plan,), tmp)]
    into_one = checkpoint_job(CPU, ck_spec(job, spec, "restore",
                                           tmp / "mesh", mesh=False))
    return kind, out, one, into_one


def test_meshed_resume_is_bit_exact_and_restores_into_one_process(runs):
    kind, out, _, into_one = runs
    for r in out:
        whole, got = r["whole"], r["resume"]
        assert torch.equal(got["trace"], whole["trace"])
        assert_equal(got["state"], whole["state"])
        assert got["files"] == FILES
    # The meshed file at FIRST, into one process.
    assert_equal(into_one["restored"], got["restored"])
    assert_close(into_one, {"trace": whole["trace"][FIRST:],
                            "state": whole["state"]}, RTOL[kind])


def test_one_process_file_restores_into_the_mesh(runs):
    kind, out, one, _ = runs
    assert one["files"] == FILES
    for r in out:
        got = r["restore"]
        assert_equal(got["restored"], one["restored"])
        assert_close(got, {"trace": one["trace"][FIRST:],
                           "state": one["state"]}, RTOL[kind])


@pytest.mark.parametrize("kind", ["C5", "sp"])
def test_ranks_whose_generators_differ_raise(kind, tmp_path):
    job, spec = run_spec(kind)
    ck = dict(ck_spec(job, spec, "resume", tmp_path / "ck"),
              job="checkpoint", rank_seeds=True)
    msgs = ranks(raise_job, (ck,), tmp_path)
    assert all(m is not None and "generators differ" in m for m in msgs), \
        msgs
    assert not list((tmp_path / "ck").glob("ckpt_*"))

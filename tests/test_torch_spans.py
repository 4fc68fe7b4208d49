"""The port's spans (``utils/profiling.py::span``) under ``torch.profiler``.

- On the CPU, one outer step opens ``ffvd::train.sghmc`` (the SG-HMC
  phase and the window snapshot) where the case samples, and
  ``ffvd::train.adam`` (the feed and the Adam step) where it trains by
  Adam, once each.
- On the CPU, a C4 ``Trainer.run`` of two chunks, ``Trainer._replay``,
  ``multichain_moments`` of two chains (C4, and C5 with its thinning) and
  ``MultiDatasetTrainer.evaluate`` of two datasets each open the spans
  their stages name, as often as the stages run: one ``ffvd::train.read``
  a chunk, one ``ffvd::eval.rollout`` a launch (one grouped launch for
  every dataset of ``evaluate``), and every stage of an evaluation inside
  its ``ffvd::eval``.  Their results are bit-equal with
  and without a profiler.
- With no profiler, ``span`` returns one shared null context and enters no
  ``record_function``.
- On the card (``cuda``), a captured run's warm-ups and capture are
  spanned, and the card-side copies of the spans come back flagged as user
  annotations, not kernels; a graph captured while a profiler recorded
  the step's spans replays as many kernels as one captured without.

It imports nothing of JAX, so on the card's machine it runs without the
suite's conftest:

    python -m pytest tests/test_torch_spans.py --noconftest -o addopts="" -q
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.eval.ensemble import multichain_moments
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import SSMData, init_params_from_warmstart
from ffvd_tpu_torch.parallel import (MultiChainTrainer, MultiDatasetTrainer,
                                     stack_datasets)
from ffvd_tpu_torch.utils import profiling

torch.set_num_threads(2)

T = 12                              # rollout steps
NAMES = ("drive", "gas_furnace")


def _ballbeam(device="cpu", dtype=torch.float64):
    ds = create_dataset("ballbeam")
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return (SSMData(y=as_t(ds.y_train), control=as_t(ds.control)),
            init_params_from_warmstart(load_warmstart("ballbeam"),
                                       device=device, dtype=dtype))


def _train_run():
    data, p0 = _ballbeam()
    tr = Trainer(FFVDConfig(dataset="ballbeam", case=4), data)
    return tr.run(tr.init_state(p0), 4, chunk_size=2, capture=False)[1]


def _train_replay():
    data, p0 = _ballbeam()
    tr = Trainer(FFVDConfig(dataset="ballbeam", case=4), data)
    return tr._replay(tr.init_state(p0), None, None, 3, capture=False)


def _multichain(case):
    def call():
        data, p0 = _ballbeam()
        cfg = FFVDConfig(dataset="ballbeam", case=case,
                         num_posterior_samples=2, posterior_sample_spacing=2)
        g = torch.Generator().manual_seed(0)
        mct = MultiChainTrainer(cfg, data, 2)
        state = mct.init_state(mct.stack_params(p0, g))
        chains, _ = multichain_moments(mct, state, T, generator=g,
                                       thin_generator=g)
        return [a for chain in chains for a in chain]
    return call


def _multidataset():
    data, params, lens = stack_datasets(NAMES, m=12)
    mdt = MultiDatasetTrainer(FFVDConfig(dataset=NAMES[0], case=4,
                                         num_inducing=12,
                                         num_posterior_samples=2), data)
    out = mdt.evaluate(mdt.init_state(params),
                       [create_dataset(n) for n in NAMES], lens,
                       generator=torch.Generator().manual_seed(0), horizon=T)
    return [s[k] for s in out.values() for k in ("rmse", "nll")]


# entry point, the spans it opens (name → count), the outer span that holds
# every other, if any
CASES = {
    "train-run": (_train_run, {"ffvd::train.run": 1, "ffvd::train.read": 2,
                               "ffvd::train.adam": 4}, "ffvd::train.run"),
    "train-replay": (_train_replay, {"ffvd::train.replay": 1,
                                     "ffvd::train.adam": 3}, None),
    "multichain-C4": (_multichain(4), {
        "ffvd::eval": 1, "ffvd::eval.prep": 1, "ffvd::eval.rollout": 1,
        "ffvd::eval.moments": 1}, "ffvd::eval"),
    "multichain-C5": (_multichain(5), {
        "ffvd::eval": 1, "ffvd::eval.prep": 1, "ffvd::eval.thin": 1,
        "ffvd::eval.rollout": 1, "ffvd::eval.moments": 1}, "ffvd::eval"),
    # the generators, then a build and a prep a dataset, one grouped
    # launch for both datasets, and the scores with their one host copy
    "multidataset": (_multidataset, {
        "ffvd::eval": 1, "ffvd::eval.prep": 3, "ffvd::eval.build": 2,
        "ffvd::eval.rollout": 1, "ffvd::eval.moments": 1}, "ffvd::eval"),
}


def _spans(prof):
    """(name, start, end) of every ``ffvd::`` host range of ``prof``."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith("ffvd::")
            and not str(e.device_type).endswith("CUDA")]


def _as_arrays(out):
    return [np.asarray(o.detach().cpu() if torch.is_tensor(o) else o)
            for o in (out if isinstance(out, list) else [out])]


@pytest.mark.parametrize("case", list(CASES))
def test_spans_of_each_entry_point(case):
    call, counts, outer = CASES[case]
    plain = _as_arrays(call())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _as_arrays(call())
    spans = _spans(prof)
    assert collections.Counter(n for n, _, _ in spans) == counts
    if outer is not None:
        # the first-opened outer span holds every span of the call
        _, s0, e0 = min((s for s in spans if s[0] == outer),
                        key=lambda s: s[1])
        assert all(s0 <= s and e <= e0 for _, s, e in spans)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


# case → the spans one outer step opens
STEP_SPANS = {4: {"ffvd::train.adam": 1},
              5: {"ffvd::train.sghmc": 1, "ffvd::train.adam": 1}}


@pytest.mark.parametrize("case", sorted(STEP_SPANS))
def test_outer_step_spans(case):
    data, p0 = _ballbeam()
    tr = Trainer(FFVDConfig(dataset="ballbeam", case=case), data)
    plain = tr.outer_step(tr.init_state(p0), torch.Generator().manual_seed(3))
    state = tr.init_state(p0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = tr.outer_step(state, torch.Generator().manual_seed(3))
    assert collections.Counter(n for n, _, _ in _spans(prof)) == \
        STEP_SPANS[case]
    np.testing.assert_array_equal(plain.numpy(), traced.numpy())


def test_outer_step_opens_no_range_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    data, p0 = _ballbeam()
    tr = Trainer(FFVDConfig(dataset="ballbeam", case=5), data)
    tr.outer_step(tr.init_state(p0), torch.Generator().manual_seed(3))
    assert made == []


def test_span_is_shared_null_context_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    off = profiling.span("ffvd::eval")
    assert off is profiling.span("ffvd::train.run")
    with off, off:
        pass
    _multichain(4)()
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("ffvd::eval"):
            pass
    assert made == ["ffvd::eval"]


@pytest.mark.cuda
def test_captured_run_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ffvd_tpu_torch.utils import graphs
    data, p0 = _ballbeam("cuda", torch.float32)
    tr = Trainer(FFVDConfig(dataset="ballbeam", case=4), data)
    state = tr.init_state(p0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(state, 6, chunk_size=3, capture=True)
        torch.cuda.synchronize()
    counts = collections.Counter(n for n, _, _ in _spans(prof))
    # the step's own spans in the eager warm-ups and the capture only
    assert counts == {"ffvd::train.run": 1, "ffvd::train.replay": 2,
                      "ffvd::train.read": 2,
                      "ffvd::graph.warmup": graphs.WARMUP,
                      "ffvd::graph.capture": 1,
                      "ffvd::train.adam": graphs.WARMUP + 1}
    on_card = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and e.name.startswith("ffvd::")]
    assert all(getattr(e, "is_user_annotation", False) for e in on_card)


@pytest.mark.cuda
def test_step_spans_leave_the_replay_as_it_was():
    """A C4 graph captured while a profiler recorded the step's spans, and
    one captured with none, replay the same kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, p0 = _ballbeam("cuda", torch.float32)
    kernels = []
    for spans_on in (True, False):
        tr = Trainer(FFVDConfig(dataset="ballbeam", case=4), data)
        state = tr.init_state(p0)
        if spans_on:
            with profile(activities=[ProfilerActivity.CPU]):
                tr.run(state, 4, capture=True)
        else:
            tr.run(state, 4, capture=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.run(state, 3, capture=True)
            torch.cuda.synchronize()
        kernels.append(sum(1 for e in prof.events()
                           if str(e.device_type).endswith("CUDA")
                           and not getattr(e, "is_user_annotation", False)))
    assert kernels[0] == kernels[1] > 0

"""Faults planted under the timed path, to show that the check catches them:
each is a context manager that patches the port while it is open.

- ``unchanged``: a training step that leaves the state as it was (Adam's
  update does nothing);
- ``count_frozen``: Adam's step count stops advancing after the third
  step (every later step takes the fourth's bias corrections), as a
  captured step that froze a host value at its capture would;
- ``half_batch``: the objective over the first half of the transitions
  only, normalised by their count: the mean over the rest;
- ``answer_altered``: one rollout row's trajectory doubled where
  the rollout produces it.
"""

from __future__ import annotations

import contextlib
import functools


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged():
    import torch
    return _patched(torch.optim.Adam, "step",
                    lambda orig: lambda self, closure=None: None)


def count_frozen():
    import torch

    def make(orig):
        def step(self, closure=None):
            out = orig(self, closure)
            with torch.no_grad():
                for st in self.state.values():
                    t = st.get("step")
                    if torch.is_tensor(t):
                        t.clamp_(max=3.0)
            return out
        return step
    return _patched(torch.optim.Adam, "step", make)


def half_batch():
    import torch

    from ffvd_tpu_torch.model import elbo
    from ffvd_tpu_torch.model.params import SSMData

    def make(orig):
        def terms(params, data, **kw):
            n = data.y.shape[-2]
            half = (torch.arange(n, device=data.y.device)
                    < n // 2).to(data.y.dtype)
            mask = half if data.mask is None else data.mask * half
            return orig(params, SSMData(y=data.y, control=data.control,
                                        mask=mask), **kw)
        return terms
    return _patched(elbo, "elbo_terms", make)


@contextlib.contextmanager
def answer_altered():
    from ffvd_tpu_torch.ops import rollout

    def make(orig):
        @functools.wraps(orig)      # keeps the launch counters it updates
        def call(*args, **kw):
            xs, vs = orig(*args, **kw)
            xs = xs.clone()
            xs[0] = xs[0] * 2.0
            return xs, vs
        return call
    with _patched(rollout, "rollout", make), \
            _patched(rollout, "rollout_batched", make):
        yield


FAULTS = {"unchanged": unchanged, "count_frozen": count_frozen,
          "half_batch": half_batch, "answer_altered": answer_altered}


def for_mix(mix: dict):
    """The faults a cell of this mix can have: every cell trains in its
    set-up; an evaluation cell also produces answers."""
    names = ["unchanged", "count_frozen", "half_batch"]
    if mix["kind"] == "eval":
        names.append("answer_altered")
    return names

"""CUDA graphs of the training iteration, the thinning sub-step and the
rollout recursion's step.

The JAX package runs its loops as compiled device programs: ``Trainer``'s
``jax.jit(lax.scan(outer_step))`` over 500 iterations with one host read
a chunk (``ffvd_tpu/inference/trainer.py:261,443-471``), and the thinning
and rollout scans of ``build_collect`` (``ffvd_tpu/eval/rollout.py:
44-83,191-237``).  The card's counterpart is a CUDA graph: one iteration's
few hundred kernel launches are captured once and replayed as one launch.

A graph replays fixed addresses, with every Python value of the capture
baked in.  So the step it replays (``Trainer.outer_step``, the sampler
sub-step of ``eval.rollout.thin_posterior``, the step of
``eval.rollout.recursion_rollout``):

- reads its random numbers from a registered ``torch.Generator`` on the
  card (its Philox offset advances on every replay, as in eager runs), or
  from static input buffers into which injected draws are copied before
  each replay;
- reads and writes its state in place, the step and window counts
  included (``TrainState.counts``), and writes its nll into a static trace;
- reads nothing back to the host: the Cholesky retry is branch-free
  (``ops/chol.py``), Adam is ``capturable`` and the counts stay on the card.

The recipe is PyTorch's whole-network capture: warm-up iterations on a side
stream (real iterations, counted in the trace), one capture, then replays.
A capture that fails raises; nothing falls back to eager.  Eager and
captured runs give the same numbers: they run the same code.  On the CPU
the same body runs plainly (``capture=False``), which is how the tests hold
it against eager ``outer_step``.

A process of a meshed run (``parallel/``) captures its own step, the
counterpart of JAX's one program under ``NamedSharding``s.  The step may
all-reduce inside (over 'ep' or 'sp'): NCCL's all-reduces are kernels
that a graph captures, gloo's are host round trips that it cannot, so
``inference.trainer.capture_rule`` decides from the groups' backends.
The eager warm-ups on the side stream reach every group the step uses,
which creates each NCCL communicator before the capture.  What a meshed
run sums or gathers after a step (the trace over 'dp', the rollouts over
the world) runs outside the graphs, eagerly.

Lifetime.  An owner (a trainer) is the only holder of its graphs, and
no graph refers back to it: the trainer comes into a step as an argument
of each call, so dropping the trainer frees its graphs by reference
counting alone.  A graph that captured NCCL's all-reduces holds its
communicators until it is freed, and ``destroy_process_group`` waits for
them.  So a trainer whose step all-reduces over NCCL
(``Trainer.graphs_per_call``) keeps its graphs only for the outermost
call that made them (``graph_scope``: ``Trainer.run``,
``run_with_checkpoints``, ``thin_posterior``, ``collect_posterior``,
``recursion_rollout``, ``multichain_moments``): within it a graph is
captured once and replayed, and when it returns the graphs go and their
counts stay (``graph_stats``).  A plain ``destroy_process_group`` then
returns with the trainer alive.  Other graphs live as long as their
trainer and serve its later calls.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ffvd_tpu_torch.utils.profiling import spanned

# Eager iterations before the capture: the first creates Adam's moments and
# the libraries' handles and workspaces on the side stream, the second runs
# with all of them in place.
WARMUP = 2
# Iterations a training graph's static nll trace holds before ``run``
# copies it out (JAX's default chunk).
TRACE_CAP = 500
# Where an owner keeps its graphs: the training step's, the thinning
# sub-step's and the rollout recursion's.
GRAPH_ATTRS = ("_graph", "_thin_graph", "_rollout_graph")


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a dict / list / tuple tree (None kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def copy_into(static, tree) -> None:
    """Copy the tensors of ``tree`` into those of ``static``, a tree of the
    same signature."""
    for dst, src in zip(_leaves(static), _leaves(tree)):
        dst.copy_(src)


def signature(tree) -> tuple:
    """The shapes and dtypes of a tree's tensors, in order, with its keys:
    a graph's static inputs serve the draws of one signature."""
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    return None if tree is None else (tuple(tree.shape), tree.dtype)


def to_device(draws: dict, device, feed_shape: Tuple[int, ...]) -> dict:
    """``outer_step``'s draw keywords as tensors on ``device``: a ``feed``
    index of ints becomes an int64 tensor of the member shape."""
    def as_t(v):
        return v.to(device) if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v), device=device)
    out = {}
    for k, v in draws.items():
        if k == "feed" and v is not None and not torch.is_tensor(v):
            v = np.asarray(v, dtype=np.int64).reshape(feed_shape)
        out[k] = tree_map(as_t, v)
    return out


def fingerprint(generator, tensors) -> tuple:
    """What a captured step is bound to: the generator it draws from and
    the addresses of the tensors it reads and writes."""
    return id(generator), tuple(t.data_ptr() for t in tensors)


def data_tensors(trainer) -> list:
    return [v for v in vars(trainer.data).values() if torch.is_tensor(v)]


def train_fingerprint(trainer, state, generator) -> tuple:
    """A training step's binding: the state's tensors and the data."""
    return fingerprint(generator, state.tensors() + data_tensors(trainer))


class StepGraph:
    """``body(inputs, *args)``, a step that works in place on tensors of
    fixed address, run plainly (``capture=False``) or replayed from a CUDA
    graph.  Each call copies ``inputs`` (a tree of the first call's
    signature) into the static buffers that ``body`` reads, then runs one
    step: the first ``WARMUP`` calls eagerly on a side stream, the next
    captures the graph and replays it, every later one replays it.
    ``args`` reach ``body`` on the calls that run it (the owner, which the
    graph does not hold)."""

    def __init__(self, body: Callable, inputs, capture: bool,
                 generator: Optional[torch.Generator] = None):
        if capture and generator is not None \
                and generator.device.type != "cuda":
            raise ValueError(
                "a captured step draws on the card: its torch.Generator must "
                f"be a CUDA generator, not one on {generator.device} (it "
                "would draw on the host and copy to the card)")
        self.body = body
        self.static = tree_map(torch.clone, inputs)
        self.capture = capture
        self.generator = generator
        self.graph = None
        self.warm_left = WARMUP
        self.stream = None
        self.replays = 0
        self.capture_s = None        # host seconds to capture and instantiate
        self.pool_bytes = None       # device memory the capture reserved

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def stats(self) -> dict:
        """The counts that outlive the graph (``release``)."""
        return {"captured": self.captured, "replays": self.replays,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes}

    def free(self) -> None:
        """Free the captured graph and its memory pool now, whoever still
        refers to this object."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None

    def __call__(self, inputs, *args) -> None:
        copy_into(self.static, inputs)
        if not self.capture:
            self.body(self.static, *args)
            return
        if self.graph is None:
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            if self.warm_left:
                self._warm_up(args)
                return
            self._capture(args)
        self.graph.replay()
        self.replays += 1

    @spanned("ffvd::graph.warmup")
    def _warm_up(self, args) -> None:
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.body(self.static, *args)
        current.wait_stream(self.stream)
        self.warm_left -= 1

    @spanned("ffvd::graph.capture")
    def _capture(self, args) -> None:
        # MAGMA's Cholesky synchronises inside; cuSOLVER's does not.
        torch.backends.cuda.preferred_linalg_library("cusolver")
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        # Freeing a graph during a capture would end the capture.  The
        # port's graphs sit in no reference cycle, so reference counting
        # frees them where their owner lets go; the cyclic collector, which
        # may free a graph that code outside the port holds in a cycle,
        # stays off while capturing.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self.body(self.static, *args)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph = graph


class TrainGraph:
    """``trainer.outer_step(state, generator, **draws)`` as a ``StepGraph``
    (captured on the card, plain on the CPU) whose nll goes into a static
    trace of ``TRACE_CAP`` rows at a device position: ``step`` runs one
    iteration, ``flush`` copies out the rows filled since the last flush.
    The trainer is an argument of ``step``: the graph does not hold it."""

    def __init__(self, trainer, state, generator, draws: dict,
                 capture: Optional[bool] = None):
        self.state, self.generator = state, generator
        x = state.params.x
        pos = self.pos = torch.zeros(1, dtype=torch.int64, device=x.device)
        trace = self.trace = x.new_zeros((TRACE_CAP,) + tuple(trainer.lead))
        self.filled = 0

        def body(d, trainer):
            nll = trainer.outer_step(state, generator, **d)
            trace.index_copy_(0, pos, nll.unsqueeze(0))
            pos.add_(1)

        if capture is None:
            capture = trainer.capture_mode(state, None)
        self.graph = StepGraph(body, draws, capture, generator)
        # What it serves: draws of this signature, these addresses.
        self.sig = signature(draws)
        self.fp = train_fingerprint(trainer, state, generator)

    def step(self, trainer, draws: dict) -> Optional[torch.Tensor]:
        """One iteration of ``trainer``'s step; returns the full trace
        first when it is full."""
        out = self.flush() if self.filled == TRACE_CAP else None
        self.graph(draws, trainer)
        self.filled += 1
        if not self.graph.captured:   # a warm-up may have made Adam's state
            self.fp = train_fingerprint(trainer, self.state, self.generator)
        return out

    def flush(self) -> Optional[torch.Tensor]:
        if not self.filled:
            return None
        out = self.trace[:self.filled].clone()
        self.pos.zero_()
        self.filled = 0
        return out


@contextlib.contextmanager
def graph_scope(owner):
    """The span of one call of the port that may make ``owner``'s graphs.
    Scopes nest; when the outermost one ends (returning or raising), an
    owner whose step all-reduces over NCCL (``owner.graphs_per_call``)
    lets its graphs go (``release``).  A caller may open one around
    several calls to capture once for all of them, and must close it
    before ``destroy_process_group``."""
    depth = owner.__dict__.get("_scope_depth", 0)
    owner._scope_depth = depth + 1
    try:
        yield
    finally:
        owner._scope_depth = depth
        if not depth and owner.graphs_per_call:
            release(owner)


def scoped(fn: Callable) -> Callable:
    """``fn(owner, ...)`` inside ``graph_scope(owner)``."""
    @functools.wraps(fn)
    def call(owner, *args, **kw):
        with graph_scope(owner):
            return fn(owner, *args, **kw)
    return call


def release(owner) -> None:
    """Drop ``owner``'s graphs (``GRAPH_ATTRS``) once the card has run
    their last replays, keeping each one's ``StepGraph.stats`` for
    ``graph_stats``.  Each captured graph is freed here (``StepGraph.
    free``), even where a reference to it outlives the call (a frame kept
    by a traceback or by a cycle that the collector has not reached)."""
    gone = {a: owner.__dict__.pop(a) for a in GRAPH_ATTRS
            if owner.__dict__.get(a) is not None}
    if any(g.graph.captured for g in gone.values()):
        torch.cuda.synchronize()
    owner._released = {**owner.__dict__.get("_released", {}),
                       **{a: g.graph.stats() for a, g in gone.items()}}
    for g in gone.values():
        g.graph.free()


def graph_stats(owner, attr: str = "_graph") -> Optional[dict]:
    """``StepGraph.stats`` of the last graph that ``owner`` kept under
    ``attr``, live or released; None if it made none."""
    g = owner.__dict__.get(attr)
    if g is not None:
        return g.graph.stats()
    return owner.__dict__.get("_released", {}).get(attr)

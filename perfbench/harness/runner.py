"""One run of one cell: set-up, the measured window, the check, the result.

The general traffic generator.  A mix (``mixes/<traffic>.json``) is data:

- ``kind`` "train": a closed loop of training calls, each
  ``chunk_size`` iterations of every member (the call's own host read
  ends it), until ``--seconds`` have passed;
- ``kind`` "eval": ``setup_train_iters`` training iterations in set-up,
  then a closed loop of evaluation calls, each with its own rollout seed,
  until ``--seconds`` have passed; ``checked_calls`` of them, drawn from
  the seed, are held against the reference;
- every mix: ``check_steps`` training iterations in set-up that the
  reference follows, the first ``stepwise_steps`` of them one call each
  (``harness.check``); ``--trace 1`` runs the window untraced, then traces
  ``trace_chunks`` training calls or ``trace_seconds`` of evaluation
  calls after it, and so does ``--trace 0`` in a cell with an end-to-end
  metric read from the card's trace.

Everything the run draws comes from ``--seed`` through one
``numpy.random.SeedSequence``: the inputs (``systems.<name>.make_inputs``),
the evaluation calls' seeds and the sample of checked calls.  The
reference's members (``make_members``) are built once the window has
closed, outside ``setup_s``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from perfbench.harness import check, guards, manifest, trace


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _np(t) -> np.ndarray:
    """A float64 copy on the host."""
    return t.detach().cpu().numpy().astype(np.float64)


class Sample:
    """A uniform sample of ``k`` items of a stream of unknown length
    (reservoir sampling), its choices drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def reference_outputs(cell: manifest.Cell, members, call_seeds, dtype,
                      device) -> dict:
    """What the reference computes in the program's place, in ``dtype``:
    set-up's training of every member from its own start (its leaves
    rounded to the configuration's dtype), laid out as the program's
    (``Run.prog_steps``), and the evaluation of each of ``call_seeds`` from
    the leaves that it trained."""
    import torch
    mix, ref = cell.mix, cell.reference
    stored = getattr(torch, cell.config["dtype"])
    total = training_steps(mix)
    steps = {"nll": [], "grad": [{} for _ in range(mix["stepwise_steps"])],
             "start": {}, "after": {}}
    trained = {}
    for mem in members:
        ser = mem["series"]
        y = torch.as_tensor(ser["y_train"], dtype=dtype, device=device)
        ctrl = torch.as_tensor(ser["control"], dtype=dtype, device=device)
        p = ref.as_tensors(mem["leaves"], dtype, device, stored)
        nll, grads, snap, last = ref.train_steps(
            p, y, ctrl, total, mix["stepwise_steps"], mix["check_steps"])
        steps["nll"].append(_np(nll))
        for t, g in enumerate(grads):
            for k, v in g.items():
                steps["grad"][t].setdefault(k, []).append(_np(v))
        for name, tree in (("start", p), ("after", snap), (None, last)):
            for k, v in tree.items():
                (steps[name] if name else trained).setdefault(
                    k, []).append(_np(v))
    steps["nll"] = np.stack(steps["nll"], axis=1)
    s = cell.config["model"]["num_posterior_samples"]
    calls = [(cs, cell.system.expected(ref, members, trained, cs, s, dtype,
                                       device)) for cs in call_seeds]
    return {"steps": steps, "calls": calls}


def training_steps(mix: dict) -> int:
    """The training iterations of a run's set-up."""
    return max(mix["check_steps"], mix.get("setup_train_iters", 0))


def set_tf32(on: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class Run:
    """A cell's system, built from the seed, through set-up."""

    def __init__(self, cell: manifest.Cell, seed: int, device: str,
                 log: Callable[[str], None] = lambda s: None):
        import torch
        self.cell, self.device = cell, device
        cfg, mix = cell.config, cell.mix
        self.dtype = getattr(torch, cfg["dtype"])
        set_tf32(cfg["tf32"])
        self.root = manifest.ROOT / cfg["data_dir"]
        streams = np.random.SeedSequence(seed).spawn(3)
        self.inputs_rng, calls_rng, pick_rng = (np.random.default_rng(s)
                                                for s in streams)
        self.call_seeds = (int(x) for x in iter(
            lambda: calls_rng.integers(2 ** 63), None))
        self.sample = Sample(mix.get("checked_calls", 0), pick_rng)
        t0 = time.perf_counter()
        stamp = lambda what: log(f"set-up: {what} at "
                                 f"{time.perf_counter() - t0:.3f} s")
        self.inputs = cell.system.make_inputs(cfg, self.inputs_rng,
                                              cell.reference, self.root)
        stamp("inputs made")
        self.sut = cell.system.System(cfg, self.inputs, device, self.dtype)
        _sync(device)
        stamp("system built")
        self.work = self.sut.work
        self.chunk = mix["chunk_size"]
        self.prog_steps = self.checked_training(mix)
        stamp(f"{mix['check_steps']} checked steps")
        left = training_steps(mix) - mix["check_steps"]
        if left > 0:
            self.prog_steps["nll"] = np.concatenate(
                [self.prog_steps["nll"], _np(self.sut.train(left,
                                                            self.chunk))])
            stamp(f"{left} more steps")
        if mix["kind"] == "eval":
            self.sut.evaluate(next(self.call_seeds))      # warm-up
            stamp("warm-up evaluation")
        _sync(device)

    def checked_training(self, mix: dict) -> dict:
        """The steps the reference follows, through the window's own call:
        ``stepwise_steps`` calls of one iteration, each followed by a read
        of Adam's first moments (so a replayed step's gradient is seen),
        then the rest of ``check_steps`` in one call."""
        start = self.sut.leaves()
        nll, moments = [], []
        for _ in range(mix["stepwise_steps"]):
            nll.append(_np(self.sut.train(1, self.chunk)))
            moments.append(self.sut.first_moment())
        rest = mix["check_steps"] - mix["stepwise_steps"]
        if rest > 0:
            nll.append(_np(self.sut.train(rest, self.chunk)))
        return {"nll": np.concatenate(nll),
                "grad": check.grads_from_moments(moments),
                "start": start, "after": self.sut.leaves()}

    # -- the window --------------------------------------------------------

    def window(self, seconds: float, traced: bool):
        """One closed loop: for ``seconds`` untraced, or traced for the
        mix's ``trace_chunks`` training calls or ``trace_seconds`` of
        evaluations.  Returns (calls, seconds, each call's seconds, the
        traced ``Window`` or None)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        mix = self.cell.mix
        kind = mix["kind"]
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts) if traced else contextlib.nullcontext()
        durations: List[float] = []
        with prof, record_function(trace.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                a = time.perf_counter()
                if kind == "train":
                    with record_function("train.chunk"):
                        self.sut.train(self.chunk, self.chunk)
                else:
                    cs = next(self.call_seeds)
                    with record_function("eval.call"):
                        out = self.sut.evaluate(cs)
                    self.sample.offer((cs, out))
                durations.append(time.perf_counter() - a)
                elapsed = time.perf_counter() - t0
                if not traced:
                    done = elapsed >= seconds
                elif kind == "train":
                    done = len(durations) >= mix["trace_chunks"]
                else:
                    done = elapsed >= mix["trace_seconds"]
                if done:
                    break
            _sync(self.device)
            wall = time.perf_counter() - t0
        win = None
        if traced:
            win = trace.window_of(prof, kind, self.units(len(durations)),
                                  self.work, self.device_name())
        return len(durations), wall, durations, win

    def units(self, calls: int) -> int:
        """Training iterations (of the whole step) or evaluations."""
        return calls * self.chunk if self.cell.mix["kind"] == "train" \
            else calls

    def device_name(self) -> str:
        import torch
        if torch.device(self.device).type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    # -- the check ---------------------------------------------------------

    def program_outputs(self) -> dict:
        """What the check reads of the program, on the host: the set-up
        steps and the sampled evaluations."""
        return {"steps": self.prog_steps, "calls": list(self.sample.items)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        import torch
        del self.sut
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def members(self) -> list:
        """The reference's members, built from the raw files and the same
        inputs that the program was given."""
        return self.cell.system.make_members(
            self.cell.config, self.inputs, self.cell.reference, self.root)


def judge(cell: manifest.Cell, got: dict, want: dict, members
          ) -> Dict[str, float]:
    """Every number of the check: ``got``'s set-up steps and evaluations
    (the program's, or the control's) against ``want``'s (the
    reference's)."""
    n_real = [m["series"]["y_train"].shape[0] for m in members]
    numbers = check.train_numbers(got["steps"], want["steps"], n_real)
    if got["calls"]:
        numbers.update(check.worst([
            cell.system.compare(out, ref_out)
            for (_, out), (_, ref_out) in zip(got["calls"], want["calls"],
                                              strict=True)]))
    return numbers


def compare(cell: manifest.Cell, members, outputs: dict, device
            ) -> Dict[str, float]:
    """The program's outputs against the float64 reference's."""
    import torch
    truth = reference_outputs(cell, members, [cs for cs, _ in
                                              outputs["calls"]],
                              torch.float64, device)
    return judge(cell, outputs, truth, members)


def end_to_end(cell: manifest.Cell, calls: int, wall: float,
               durations: List[float], members: int, chunk: int,
               setup_s: float, win: Optional[trace.Window]) -> dict:
    """The host-clock metrics from the untraced window, and those read from
    the traced one (``win``) by their readers."""
    values = {"setup_s": setup_s}
    if cell.mix["kind"] == "train":
        values["train_iters_per_s"] = members * calls * chunk / wall
    else:
        values["evals_per_s"] = calls / wall
        values["eval_ms_p95"] = float(np.percentile(
            np.asarray(durations) * 1e3, 95))
    for m in cell.end_to_end:
        if manifest.traced(m) and win is not None:
            values[m["name"]] = cell.readers[m["name"]].read(win)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}


def per_layer(cell: manifest.Cell, win: trace.Window) -> dict:
    out = {}
    for m in cell.per_layer:
        v = cell.readers[m["name"]].read(win)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", overrides: Optional[dict] = None,
             t_start: Optional[float] = None,
             log: Callable[[str], None] = lambda s: None) -> dict:
    """One run of cell ``name``: the result line's object.  Raises if the
    process holds JAX or the JAX package once the window has closed.
    Traced, or where an end-to-end metric of the cell is read from the
    card's trace, a traced window follows the untraced one; the host-clock
    readings, the per-layer ones too, come from the untraced window."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.cell(name, overrides)
    run = Run(cell, seed, device, log)
    setup_s = time.perf_counter() - t_start
    calls, wall, durations, _ = run.window(seconds, False)
    q = np.percentile(durations, [0, 50, 100]) * 1e3
    log(f"window: {calls} calls in {wall:.3f} s, a call's ms min "
        f"{q[0]:.3f} median {q[1]:.3f} max {q[2]:.3f}")
    win = None
    if traced or any(manifest.traced(m) for m in cell.end_to_end):
        t_calls, t_wall, _, win = run.window(seconds, True)
        win.timed(run.units(calls), wall, durations)
        log(f"traced window: {t_calls} calls in {t_wall:.3f} s, the card "
            f"busy {win.busy_us / win.units:.3f} us a unit")
    found = guards.forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {found} after the window")
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    result = {"correct": False, "attempted": calls, "failed": 0}
    if traced:
        result["metrics"] = per_layer(cell, win)
    else:
        result["metrics"] = end_to_end(cell, calls, wall, durations,
                                       run.sut.members, run.chunk, setup_s,
                                       win)
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": run.device_name(),
                        "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        result["device"].update(busy_s=win.busy_us * 1e-6,
                                 window_s=win.wall_us * 1e-6)
        result["breakdown"] = trace.breakdown(win)
    outputs = run.program_outputs()
    run.release()
    t0 = time.perf_counter()
    numbers = compare(cell, run.members(), outputs, device)
    log(f"check: the reference took {time.perf_counter() - t0:.3f} s")
    v = check.verdict(numbers, cell.config["limits"])
    result["correct"] = v["correct"]
    result["checks"] = v["checks"]
    return result

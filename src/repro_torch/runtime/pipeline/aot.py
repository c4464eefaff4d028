"""Warm-up accounting for stage programs: no first call inside a timed window.

The JAX package compiles every stage program ahead of time (its
``aot.py``), so that no served request waits for a compile.  PyTorch
compiles nothing ahead: what a program's first call at a shape pays is
the kernel library's build and load (`kernels.build`, once a process) and
the first launch at that shape from a thread on a stream: PyTorch keeps
a cuBLAS handle a thread and a cuBLAS workspace a (handle, stream), decode
attention a workspace a stream, and the caching allocator its blocks a
stream.  So here:

  * `AotProgram` wraps one stage function and keeps the set of (shape,
    thread, stream) it has run at; ``precompile`` runs it once on scratch
    inputs of a shape, on the thread and stream that will run it, before
    the engine's clock starts;
  * a call at a (shape, thread, stream) not seen before is a *compile*:
    counted in the shared `CompileStats`, and *late* when it lands inside
    a timed window (the engine is running).  Pipelines expose this as
    ``pipe.compile_stats`` and tests assert ``late == 0`` after warm-up.

Over ranks (`remote`) each rank keeps its own stats: it warms its own
(stage, replica)s on their lanes, opens its window when the controller's
run starts, and reports its first calls at the run's end, which the
controller adds to its ``compile_stats`` (per rank in the result's
``ranks``).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class CompileStats:
    """First-call accounting for one pipeline's programs."""
    compiles: int = 0              # first calls at a shape, by any route
    compile_s: float = 0.0         # host wall time of those first calls
    late: int = 0                  # first calls that landed INSIDE a timed
    #                                window (the engine was running) — the
    #                                number warm-up exists to keep at zero
    misses: int = 0                # first calls outside any window that
    #                                did not come through ``precompile``
    calls: int = 0                 # calls after warm-up
    in_window: bool = False        # set by the pipeline around engine.run()
    programs: dict[str, int] = field(default_factory=dict)  # name -> compiles
    # one stats object is shared by every program of a pipeline, and op
    # bodies run on the engine's worker threads — counter updates take a lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def note(self, name: str, seconds: float, on_miss: bool) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_s += seconds
            self.programs[name] = self.programs.get(name, 0) + 1
            if on_miss:
                if self.in_window:
                    self.late += 1
                else:
                    self.misses += 1

    def count_call(self) -> None:
        with self._lock:
            self.calls += 1

    @contextmanager
    def window(self):
        """Mark a timed window (the engine is running): first calls inside
        it count as ``late``.  Pipelines wrap ``engine.run()`` in this."""
        self.in_window = True
        try:
            yield
        finally:
            self.in_window = False

    def summary(self) -> str:
        per = ", ".join(f"{n}: {c}" for n, c in sorted(self.programs.items()))
        return (f"{self.compiles} first calls in {self.compile_s:.2f}s "
                f"({self.late} late, {self.misses} out-of-window misses), "
                f"{self.calls} calls [{per}]")


def signature(x):
    """Hashable shape of an argument: shape, dtype and device of each
    tensor, the structure of lists and dicts, and plain values."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, dict):
        return tuple((k, signature(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(signature(v) for v in x)
    return x


def _where() -> tuple:
    """The calling thread and its current CUDA stream (None where CUDA is
    not in use)."""
    stream = torch.cuda.current_stream().cuda_stream \
        if torch.cuda.is_initialized() else None
    return threading.get_ident(), stream


class AotProgram:
    """One stage program, ``fn(params, *args)``, warmed per shape, thread
    and stream.

    ``precompile`` takes the same arguments as a call (scratch tensors of
    the shapes to come), runs the program once, and returns its output;
    a call at a (shape, thread, stream) that no call or ``precompile``
    has run is counted as a compile (late inside a timed window)."""

    def __init__(self, fn, *, name: str = "", stats: CompileStats | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "program")
        self.stats = stats if stats is not None else CompileStats()
        self._seen: set = set()
        self._lock = threading.Lock()

    def _first(self, key) -> bool:
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True

    def precompile(self, params, *args):
        first = self._first((signature(args), _where()))
        t0 = time.perf_counter()
        out = self.fn(params, *args)
        if first:
            self.stats.note(self.name, time.perf_counter() - t0, on_miss=False)
        return out

    def __call__(self, params, *args):
        if not self._first((signature(args), _where())):
            self.stats.count_call()
            return self.fn(params, *args)
        t0 = time.perf_counter()
        out = self.fn(params, *args)
        self.stats.note(self.name, time.perf_counter() - t0, on_miss=True)
        return out

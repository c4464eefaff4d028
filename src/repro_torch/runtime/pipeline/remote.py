"""Pipelines over a process group: a process a rank, each rank one JAX device.

The JAX package is single-controller: one process drives every device, and
running a stage on another device is a ``device_put`` and a dispatch.
PyTorch is SPMD, so a pipeline over N devices is N processes here, one rank
each (`launch.mesh.RankPool`).  The pool's first rank is the *controller*:
every rank builds the same pipeline, and the controller alone schedules
(the engine, the schedule's op order, the fold order, a server's groups),
so each decision is made where the one-rank pipeline makes it.  Every
rank, the controller included, runs a `Worker` that executes the
controller's commands on its own stage modules, each op body on the lane
thread and stream of its (stage, replica), and reports each op done.

Commands and reports.  A message is a dict, pickled, sent as its length
and then its bytes over the pool's gloo ``control`` group: commands to a
worker on tag 1, reports to the controller on tag 2; the controller's own
worker takes its commands from an in-process queue.  A ``run`` command
names the pipeline handler (``fn``: its ``_on_<fn>`` method), where it runs
(``lane``: a (stage, replica) lane thread, or None for the worker's own
thread, in command order) and each tensor input: ``("value", array)``
inline (token ids), ``("store", key, pop)`` from this rank's store, or
``("recv", src, tag, meta)`` from another rank.  A report carries the
command's id, the handler's host seconds and its small results (shapes, a
loss, sampled token ids), or the error it raised, with the rank and the op.

Data.  An op's outputs stay in its rank's store, under keys the controller
names.  When a consumer on another rank is dispatched, the controller sends
the holder a ``send`` command and the consumer a ``run`` whose input is a
``recv``: the tensor goes from producer rank to consumer rank on the
``data`` group, never through the controller.  Each worker posts its sends
and receives on its own thread in command order, and the controller issues
both sides of a transfer at one point of its order, so between any two
ranks the sends and receives are posted in the same order on both sides
(NCCL matches them by order, gloo by tag: one tag a tensor, from a counter).
A receive is waited for on the lane that runs the op, within the pool's
time limit.  Over gloo on the card a tensor is copied to the host to be
sent, and back to the card on the consumer's stream once received.

Why this cannot deadlock: a worker's own thread blocks only in a receive
whose send the controller issued earlier, or in a collective of a tp slice
whose other ranks got the same command at the same point of the order; so
the earliest blocked command, in the controller's order, can always go on.

What the self-healing drills add.  An input that a lost op may need again
is *kept* (``inputs_for(keep=True)``): its holder neither pops it nor sends
it away for good, and the controller drops it there (``drop``) once the
consuming op, or its redo on a survivor, retired.  ``move`` sends a store
entry (a tensor, a list, or a tree such as a cache slice, `TreeMeta`) from
one rank to another under a new key at one point of the controller's
order, and is a rename on the same rank: migration, a resume's transfer
and a successor's weights use it.  A ``run`` command may carry ``stall_s``,
slept on its lane before the body (an injected straggler is slow on its
own rank).  Parked cache slices (keys ``("parked", ...)``) live in this
process's `PARKED` store, which a run's ``begin`` leaves alone and every
pipeline's worker on the rank reads, so a successor built on the same
ranks adopts them; the `ResumeState` that names them frees what it does
not adopt.  After a `failures.PipelineFailure` the controller waits every
posted command home and drops its report (``drain``), and every rank
empties its store of the failed run's tensors; a command that raised on
its rank meanwhile is raised then (a `RankFailure` caused by the
`PipelineFailure`), never dropped.  After any other failure of a run (a
rank's own fault, raised as the first `RankFailure` the controller took)
the controller drops the late reports of the commands the run left in
flight (``abandon``): another op of the run that failed on its rank is the
same fault, and must not fail the ``end`` or the ``stop`` that follow.  A
worker's ``stop`` report is its last message: once it is sent, the
controller may close the group, so an error in waiting that send home is
not the worker's (the controller raises where the report did not come).
"""
from __future__ import annotations

import itertools
import pickle
import queue
import threading
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..failures import PipelineFailure
from .engine import AsyncResult, RemoteWatch

CMD_TAG, REPORT_TAG = 1, 2
IDLE_S = 2e-4           # a loop's sleep when nothing moved
PARKED: dict = {}       # this process's parked cache slices, every pipeline's
_ACTIVE = [time.monotonic()]    # when a worker of this process last took a command


class RankFailure(RuntimeError):
    """A command failed on a rank: its handler raised (the message names the
    rank, the op and the error), or no report came within the pool's time
    limit (a rank died or hangs)."""

    def __init__(self, message: str, *, rank=None, what: str = ""):
        super().__init__(message)
        self.rank = rank
        self.what = what


@dataclass(frozen=True)
class Ref:
    """A tensor, or a list of tensors, that rank ``rank`` holds in its
    store under ``key``; ``meta`` is its shape and dtype (`meta_of`)."""
    rank: int
    key: tuple
    meta: object


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _full(t):
    """A DTensor's whole value on every rank of its mesh (a collective where
    it is sharded or partial); anything else as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def launch_counts() -> dict:
    """Each kernel wrapper's launch count in this process, by kernel."""
    from ...kernels import decode_attention as da
    from ...kernels import flash_attention as fa
    from ...kernels import fused_decode as fd
    from ...kernels import rmsnorm as rn
    from ...kernels import ssd_scan as ss
    return {"rmsnorm": rn.rmsnorm.launches, "rmsnorm_bwd": rn.rmsnorm_backward.launches,
            "flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd": fa.flash_attention_backward.launches,
            "decode_attention": da.decode_attention.launches,
            "fused_qkv_rope": fd.qkv_rope.launches,
            "fused_out_residual": fd.out_residual.launches,
            "ssd_scan": ss.ssd_scan.launches, "ssd_scan_bwd": ss.ssd_scan_backward.launches,
            "rmsnorm_gated": rn.rmsnorm_gated.launches,
            "rmsnorm_gated_bwd": rn.rmsnorm_gated_backward.launches}


def meta_of(value):
    """(shape, dtype name) of a tensor's local part, a list of them for a
    list, None for None."""
    if value is None:
        return None
    if isinstance(value, (list, tuple)):
        return [meta_of(v) for v in value]
    t = _local(value)
    return (tuple(t.shape), str(t.dtype).removeprefix("torch."))


@dataclass(frozen=True)
class TreeMeta:
    """The meta of a nested dict / list of tensors (a cache slice): its
    structure (`tree_flatten`'s ``spec``) and each leaf's (shape, dtype)."""
    spec: object
    leaves: tuple

    @property
    def nbytes(self) -> int:
        return sum(int(np.prod(shape)) * getattr(torch, dt).itemsize
                   for shape, dt in self.leaves)


def tree_flatten(value) -> tuple[list, object]:
    """(the tensors of a nested dict / list / tuple in a fixed order, its
    structure): a leaf's structure is None."""
    if isinstance(value, dict):
        keys = tuple(value)             # in order: a program's signature reads it
        parts = [tree_flatten(value[k]) for k in keys]
        return [t for p in parts for t in p[0]], ("d", keys, tuple(p[1] for p in parts))
    if isinstance(value, (list, tuple)):
        parts = [tree_flatten(v) for v in value]
        return [t for p in parts for t in p[0]], ("l", tuple(p[1] for p in parts))
    return [value], None


def tree_unflatten(spec, leaves: list):
    """`tree_flatten`'s inverse."""
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        if sp[0] == "d":
            return {k: build(s) for k, s in zip(sp[1], sp[2])}
        return [build(s) for s in sp[1]]
    return build(spec)


def tree_meta(value) -> TreeMeta:
    leaves, spec = tree_flatten(value)
    return TreeMeta(spec, tuple(meta_of(t) for t in leaves))


def _metas(meta) -> list:
    if isinstance(meta, TreeMeta):
        return list(meta.leaves)
    return meta if isinstance(meta, list) else [meta]


def _leaves(value) -> list:
    """The tensors a send of ``value`` carries, in `_metas` order."""
    if isinstance(value, dict):
        return tree_flatten(value)[0]
    return list(value) if isinstance(value, (list, tuple)) else [value]


def _host(value):
    """A report value read on the host: a 0-d tensor as a float, another
    tensor as a numpy array."""
    if isinstance(value, torch.Tensor):
        value = _local(value).detach()
        return value.item() if value.dim() == 0 else value.cpu().numpy()
    return value


def _encode(obj) -> list[torch.Tensor]:
    body = torch.frombuffer(bytearray(pickle.dumps(obj, protocol=5)), dtype=torch.uint8)
    return [torch.tensor([body.numel()], dtype=torch.int64), body]


FOREVER = timedelta(days=365)     # a control receive waits for the next message


class _Outbox:
    """Posted sends, each kept with its buffer until it is done: a gloo send
    reports done only to ``wait()``, so a thread of its own waits for them
    in order (within the pool's time limit); ``drain`` waits for them all
    and ends that thread."""

    def __init__(self, timeout: timedelta, device):
        self.timeout = timeout
        self.device = device
        self.error: Exception | None = None
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None

    def send(self, t: torch.Tensor, dst: int, group, tag: int) -> None:
        if self.error is not None:
            raise self.error
        if self._thread is None:
            self._thread = threading.Thread(target=self._reap, daemon=True, name="sends")
            self._thread.start()
        self._q.put((dist.isend(t, dst, group=group, tag=tag), t))

    def _reap(self) -> None:
        if self.device.type == "cuda":          # an NCCL wait holds the current stream
            torch.cuda.set_stream(torch.cuda.Stream(self.device))
        while (item := self._q.get()) is not None:
            try:
                item[0].wait(self.timeout)
            except Exception as e:
                self.error = e

    def drain(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error


class _Inbox:
    """The messages from one peer on one tag, taken by a thread of its own
    (a gloo receive reports done only to ``wait()``), which ends after a
    message that ends the pipeline's traffic (``last``): a receive still
    posted when the process exits aborts it.  ``poll`` returns the next
    message, or None."""

    def __init__(self, src: int, group, tag: int, timeout: timedelta, last):
        self.src, self.group, self.tag, self.timeout, self.last = src, group, tag, timeout, last
        self.error: Exception | None = None
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._run, daemon=True, name=f"from-rank{src}")
        self.thread.start()

    def _run(self) -> None:
        try:
            while True:
                n = torch.zeros(1, dtype=torch.int64)
                dist.irecv(n, self.src, group=self.group, tag=self.tag).wait(FOREVER)
                body = torch.empty(int(n), dtype=torch.uint8)
                dist.irecv(body, self.src, group=self.group, tag=self.tag).wait(self.timeout)
                msg = pickle.loads(body.numpy().tobytes())
                self._q.put(msg)
                if self.last(msg):
                    return
        except Exception as e:
            self.error = e

    def poll(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            if self.error is not None:
                raise RankFailure(f"the link from rank {self.src} broke: {self.error}",
                                  rank=self.src) from self.error
            return None


def _inbox(pool, src: int, tag: int) -> _Inbox:
    """The pool's inbox for (``src``, ``tag``), kept on the pool while its
    thread lives: a second receiver on the same link would take the other's
    messages."""
    boxes = pool.__dict__.setdefault("_inboxes", {})
    box = boxes.get((src, tag))
    if box is None or not box.thread.is_alive():
        last = ((lambda m: m.get("do") == "stop") if tag == CMD_TAG
                else (lambda m: bool(m.get("stopped"))))
        box = boxes[(src, tag)] = _Inbox(src, pool.control, tag,
                                         timedelta(seconds=pool.timeout_s), last)
    return box


def posted(ctl, cid: int, ranks, what: str) -> AsyncResult:
    """The controller's body of an op whose commands are posted: done when
    every rank of ``ranks`` has reported command ``cid``."""
    return AsyncResult((cid,), watch=[RemoteWatch(ctl, cid, ranks, what)])


def stream_handle(stream):
    """A report's name for the CUDA stream an op ran on (None off the card)."""
    return None if stream is None else stream.cuda_stream


def _timed(stall_s: float, fn, *args):
    """(``fn(*args)``, its host seconds, the seconds it slept), after a
    host-side sleep of ``stall_s`` where one is injected (a straggler: the
    host seconds include the sleep, as on one rank)."""
    t0 = time.perf_counter()
    if stall_s:
        time.sleep(stall_s)
    out = fn(*args)
    return out, time.perf_counter() - t0, float(stall_s or 0.0)


class Worker:
    """One rank's executor of the controller's commands for ``target``, a
    pipeline: its ``_on_<fn>`` handlers and its ``lanes``.  ``store`` holds
    the tensors that ops left here; ``bytes_sent`` counts what this rank
    sent to others.  The controller's own worker gets its commands from
    ``commands`` and puts its reports on ``reports`` (in-process queues);
    any other rank's talks over the pool's control group.  ``target.worker``
    is the worker (what the rank holds can be read there)."""

    def __init__(self, pool, target, *, commands=None, reports=None):
        self.pool = pool
        self.target = target
        target.worker = self
        self.rank = pool.rank
        self.store: dict = {}
        self.parked: set = set()       # the PARKED keys this worker put there
        self.bytes_sent = 0
        self.bytes_moved = 0           # of those, what ``move`` sent
        self.timeout = timedelta(seconds=pool.timeout_s)
        self._commands = commands
        self._reports = reports
        self._inbox = None if commands is not None else _inbox(pool, pool.controller, CMD_TAG)
        self._out = _Outbox(self.timeout, pool.device)
        self._running: list = []       # (cmd, future): a lane runs its body
        self._watching: list = []      # (cmd, AsyncResult, host_s, stall_s): device
        #                                work queued

    # -- the loop ----------------------------------------------------------
    def loop(self) -> None:
        """Execute commands until a ``stop``.  A worker on another rank than
        the controller's raises `RankFailure` when no command came within the
        pool's time limit while nothing ran, here or in another pipeline's
        worker of this process (the controller died or hangs)."""
        idle_since = time.monotonic()
        limit = float("inf") if self._commands is not None else self.pool.timeout_s
        while True:
            cmd = self._next()
            if cmd is not None:
                _ACTIVE[0] = time.monotonic()
                if cmd["do"] == "stop":
                    self._finish(cmd)
                    return
                self._handle(cmd)
            moved = self._progress() or cmd is not None
            if moved or self._running or self._watching:
                idle_since = time.monotonic()
            elif time.monotonic() - max(idle_since, _ACTIVE[0]) > limit:
                raise RankFailure(f"rank {self.rank}: no command from rank "
                                  f"{self.pool.controller} in {self.pool.timeout_s:.0f} s",
                                  rank=self.rank)
            if not moved:
                time.sleep(IDLE_S)

    def _next(self):
        if self._commands is not None:
            try:
                return self._commands.get_nowait()
            except queue.Empty:
                return None
        return self._inbox.poll()

    def _finish(self, cmd) -> None:
        """``stop``: wait the running bodies home, stop the target's lanes and
        free what they made (`close_lanes`), then acknowledge."""
        for _, fut in self._running:
            try:
                fut.result()
            except Exception:
                pass
        self._running, self._watching = [], []
        self.store.clear()
        for key in self.parked:
            PARKED.pop(key, None)
        try:
            self.target.close_lanes()
            self._out.drain()
        except Exception as e:          # reported: the controller raises it
            self._fail(dict(cmd, stopped=True), e)
        else:
            self._report(cmd, {"bytes_sent": self.bytes_sent, "stopped": True})
        try:     # the report, sent last: the controller may close the group once it came
            self._out.drain()
        except Exception:
            pass

    def _handle(self, cmd) -> None:
        try:
            do = cmd["do"]
            if do == "send":
                self._send(cmd)
            elif do == "recv":
                opened = self._open(cmd["value"])
                value = self.get(opened, self.target.device)
                if cmd.get("sync") and self.target.device.type == "cuda":
                    torch.cuda.current_stream(self.target.device).synchronize()
                self.put(cmd["key"], value)
                self._report(cmd, {})
            elif do == "drop":
                for key in cmd["keys"]:
                    self.drop(key)
            elif do == "call":
                result = cmd["fn"](self.target, *cmd.get("args", ()))
                self._report(cmd, {"result": result})
            elif do == "run":
                inputs = {k: self._open(spec) for k, spec in cmd.get("inputs", {}).items()}
                fn = getattr(self.target, "_on_" + cmd["fn"])
                lane, stall = cmd.get("lane"), cmd.get("stall_s", 0.0)
                if lane is None:
                    self._done(cmd, *_timed(stall, fn, self, cmd, inputs))
                else:
                    fut = self.target.lanes.submit(lane[0], lane[1], _timed, stall, fn, self,
                                                   cmd, inputs)
                    self._running.append((cmd, fut))
            else:
                raise ValueError(f"unknown command {do!r}")
        except Exception as e:
            self._fail(cmd, e)

    def _progress(self) -> bool:
        moved = False
        for item in [it for it in self._running if it[1].done()]:
            self._running.remove(item)
            cmd, fut = item
            moved = True
            try:
                self._done(cmd, *fut.result())
            except Exception as e:
                self._fail(cmd, e)
        for item in list(self._watching):
            cmd, ar, host_s, stall_s = item
            try:
                ready = ar.is_ready()
                if ready:
                    body = {k: _host(v) for k, v in ar.payload.items()}
            except Exception as e:
                self._watching.remove(item)
                self._fail(cmd, e)
                continue
            if ready:
                self._watching.remove(item)
                self._report(cmd, dict(body, host_s=host_s, stall_s=stall_s))
                moved = True
        return moved

    def _done(self, cmd, result, host_s: float, stall_s: float) -> None:
        if isinstance(result, AsyncResult):
            self._watching.append((cmd, result, host_s, stall_s))
        else:
            self._report(cmd, dict(result or {}, host_s=host_s, stall_s=stall_s))

    # -- reports -----------------------------------------------------------
    def _report(self, cmd, body: dict) -> None:
        if not cmd.get("ack", True):
            return
        body = dict(body, id=cmd["id"], rank=self.rank)
        if self._reports is not None:
            self._reports.put(body)
            return
        for t in _encode(body):
            self._out.send(t, self.pool.controller, self.pool.control, REPORT_TAG)

    def _fail(self, cmd, e: Exception) -> None:
        tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
        self._report(dict(cmd, ack=True), {"error": f"{type(e).__name__}: {e}",
                                           "trace": tb[-4000:], "what": cmd.get("what", ""),
                                           "stopped": cmd.get("stopped", False)})

    # -- data ----------------------------------------------------------------
    def _slot(self, key) -> dict:
        """The store that holds ``key``: this process's `PARKED` for a parked
        slice, this worker's store else."""
        return PARKED if isinstance(key, tuple) and key[:1] == ("parked",) else self.store

    def take(self, key, pop: bool = True):
        slot = self._slot(key)
        return slot.pop(key) if pop else slot[key]

    def put(self, key, value) -> None:
        slot = self._slot(key)
        slot[key] = value
        if slot is PARKED:
            self.parked.add(key)

    def drop(self, key) -> None:
        self._slot(key).pop(key, None)

    def _send(self, cmd) -> None:
        """Post the sends of a store entry to each rank of ``dst``: one tag a
        tensor from ``tag`` on, each through the host over gloo on the card."""
        value = self.take(cmd["key"], cmd.get("pop"))
        staged = self.pool.host_staged
        for j, t in enumerate(_leaves(value)):
            t = _local(t).detach()
            t = (t.to("cpu") if staged else t).contiguous()
            for dst in cmd["dst"]:
                self._out.send(t, dst, self.pool.data, cmd["tag"] + j)
                n = t.numel() * t.element_size()
                self.bytes_sent += n
                self.bytes_moved += n if cmd.get("move") else 0

    def _open(self, spec):
        """An input spec made ready to take: a store entry taken now, the
        receives of a ``recv`` posted now (in command order)."""
        kind = spec[0]
        if kind == "value":
            return spec
        if kind == "store":
            _, key, pop = spec
            return ("have", self.take(key, pop))
        if kind == "recv":
            _, src, tag, meta = spec
            on = torch.device("cpu") if self.pool.transport == "gloo" else self.target.device
            bufs = [torch.empty(shape, dtype=getattr(torch, dt), device=on)
                    for shape, dt in _metas(meta)]
            works = [dist.irecv(b, src, group=self.pool.data, tag=tag + j)
                     for j, b in enumerate(bufs)]
            return ("incoming", works, bufs, meta)
        raise ValueError(f"unknown input {kind!r}")

    def get(self, opened, device):
        """An opened input's value on ``device``, on the calling thread's
        current stream: a received one waited for (within the time limit)
        and, when it came through the host, copied to ``device`` there."""
        kind = opened[0]
        if kind == "value":
            return torch.as_tensor(np.asarray(opened[1])).to(device)
        if kind == "have":
            return opened[1]
        _, works, bufs, meta = opened
        out = []
        for w, b in zip(works, bufs):
            w.wait(self.timeout)
            if b.device != device:
                b = b.to(device)
            elif device.type == "cuda":
                b.record_stream(torch.cuda.current_stream(device))
            out.append(b)
        if isinstance(meta, TreeMeta):
            return tree_unflatten(meta.spec, out)
        return out if isinstance(meta, list) else out[0]


class Controller:
    """The pool's first rank: posts commands, gathers reports, and runs its
    own rank's commands on a `Worker` thread of its own.  ``post`` issues a
    command; ``poll`` takes the reports that came (raising `RankFailure` on
    an error report); ``wait`` waits for a command's reports within the
    pool's time limit; ``fetch`` brings a `Ref` here; ``call`` runs a
    function (picklable by reference) on every rank's worker thread."""

    def __init__(self, pool, target):
        self.pool = pool
        self.rank = pool.rank
        self.timeout_s = pool.timeout_s
        self._commands: queue.SimpleQueue = queue.SimpleQueue()
        self._local_reports: queue.SimpleQueue = queue.SimpleQueue()
        self.local = Worker(pool, target, commands=self._commands, reports=self._local_reports)
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._run_local, daemon=True,
                                        name=f"rank{self.rank}-worker")
        self._thread.start()
        self.workers = [r for r in pool.ranks if r != self.rank]
        self._inboxes = {r: _inbox(pool, r, REPORT_TAG) for r in self.workers}
        self._out = _Outbox(timedelta(seconds=pool.timeout_s), pool.device)
        self.reports: dict[int, dict] = {}
        self._expect: dict[int, int] = {}      # command id -> reports it owes
        self._ids = itertools.count(1)
        self._abandoned = 0                    # the reports of commands below it are dropped
        self._tags = itertools.count(0)
        self.closed = False

    def _run_local(self) -> None:
        try:
            self.local.loop()
        except Exception as e:
            self._error = e

    def new_id(self) -> int:
        return next(self._ids)

    def new_tags(self, n: int) -> int:
        """The first of ``n`` fresh data tags."""
        base = next(self._tags)
        for _ in range(n - 1):
            next(self._tags)
        return base

    def post(self, rank: int, cmd: dict) -> int:
        cmd.setdefault("id", self.new_id())
        if cmd.get("ack", True):
            self._expect[cmd["id"]] = self._expect.get(cmd["id"], 0) + 1
        if rank == self.rank:
            self._commands.put(cmd)
        else:
            for t in _encode(cmd):
                self._out.send(t, rank, self.pool.control, CMD_TAG)
        return cmd["id"]

    def poll(self) -> None:
        if self._error is not None:
            raise RankFailure(f"rank {self.rank}'s worker stopped: {self._error}",
                              rank=self.rank) from self._error
        while True:
            try:
                self._take(self._local_reports.get_nowait())
            except queue.Empty:
                break
        for box in self._inboxes.values():
            while (rep := box.poll()) is not None:
                self._take(rep)
        if self._out.error is not None:
            raise RankFailure(f"a send from rank {self.rank} failed: {self._out.error}",
                              rank=self.rank) from self._out.error

    def _take(self, rep: dict) -> None:
        if rep["id"] < self._abandoned:
            return
        self.reports.setdefault(rep["id"], {})[rep["rank"]] = rep
        if "error" in rep:
            raise RankFailure(f"rank {rep['rank']} failed in {rep.get('what') or 'a command'}: "
                              f"{rep['error']}\n--- on rank {rep['rank']}:\n{rep['trace']}",
                              rank=rep["rank"], what=rep.get("what", ""))

    def done(self, cid: int, ranks) -> bool:
        return len(self.reports.get(cid, ())) >= len(set(ranks))

    def wait(self, cid: int, ranks, what: str, *, take: bool = True) -> dict:
        """{rank: report} of command ``cid`` once every rank of ``ranks``
        reported; `RankFailure` past the pool's time limit."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            self.poll()
            if self.done(cid, ranks):
                return self.take(cid) if take else self.reports[cid]
            if time.monotonic() > deadline:
                missing = sorted(set(ranks) - set(self.reports.get(cid, {})))
                raise RankFailure(f"no report of {what} from rank(s) {missing} in "
                                  f"{self.timeout_s:.0f} s", rank=missing[0], what=what)
            time.sleep(IDLE_S)

    def take(self, cid: int) -> dict:
        self._expect.pop(cid, None)
        return self.reports.pop(cid)

    def drain(self) -> list[RankFailure]:
        """Wait every posted command home (within the pool's time limit) and
        drop its report: what a run that failed left in flight on the ranks.
        Returns the failures the ranks reported meanwhile (a command that
        raised there), for the caller to raise."""
        deadline = time.monotonic() + self.timeout_s
        errors = []
        while True:
            try:
                self.poll()
            except RankFailure as e:
                if self._error is not None or self._out.error is not None:
                    raise
                errors.append(e)
                continue
            if all(len(self.reports.get(c, ())) >= n for c, n in self._expect.items()):
                break
            if time.monotonic() > deadline:
                raise RankFailure(f"commands {sorted(self._expect)[:8]} not home in "
                                  f"{self.timeout_s:.0f} s after a failed run")
            time.sleep(IDLE_S)
        for cid in self._expect:
            self.reports.pop(cid, None)
        self._expect.clear()
        return errors

    def abandon(self) -> None:
        """Drop the reports of every command posted so far, those still to
        come too: what a run that a rank's fault ended left in flight.
        Their ranks finish or fail them on their own; a failure among them
        is the run's, raised already."""
        self._abandoned = self.new_id()
        for cid in [c for c in self.reports if c < self._abandoned]:
            del self.reports[cid]
        self._expect = {c: n for c, n in self._expect.items() if c >= self._abandoned}

    def inputs_for(self, ref: Ref, ranks, *, keep: bool = False, move: bool = False) -> dict:
        """The input spec of ``ref`` for each rank of ``ranks``: the holder
        takes it from its store; for the others the holder is told to send it
        (one command, posted now) and each gets a ``recv``.  ``keep``: the
        holder keeps it (an op that may be lost reads it; `release` lets it
        go: `drop`).  ``move``: the bytes count as moved."""
        ranks = list(dict.fromkeys(ranks))
        away = [r for r in ranks if r != ref.rank]
        specs = {}
        if away:
            tag = self.new_tags(len(_metas(ref.meta)))
            self.post(ref.rank, {"do": "send", "key": ref.key, "dst": away, "tag": tag,
                                 "pop": not keep and ref.rank not in ranks, "ack": False,
                                 "move": move, "what": f"send {ref.key} to rank(s) {away}"})
            for r in away:
                specs[r] = ("recv", ref.rank, tag, ref.meta)
        if ref.rank in ranks:
            specs[ref.rank] = ("store", ref.key, not keep)
        return specs

    def drop(self, rank: int, keys: list, what: str) -> None:
        """Free the store entries ``keys`` on ``rank`` (a kept input, a lost
        op's output, a dead replica's or a parked slice), posted now."""
        self.post(rank, {"do": "drop", "keys": keys, "ack": False, "what": what})

    def move(self, ref: Ref, dst: int, key, *, ack: bool = True) -> int:
        """Move the store entry ``ref`` to rank ``dst`` under ``key`` (a
        rename on the same rank), posted now: the holder lets it go, and
        ``dst`` holds it, copied onto its card, before it takes its next
        command (with ``ack``, once the returned command reported).
        Returns that command's id."""
        spec = self.inputs_for(ref, [dst], move=True)[dst]
        return self.post(dst, {"do": "recv", "key": key, "value": spec, "sync": True,
                               "ack": ack,
                               "what": f"move {ref.key} from rank {ref.rank} as {key}"})

    def fetch(self, ref: Ref):
        """The value of ``ref`` here, on this rank's device (taken from its
        holder's store)."""
        spec = self.inputs_for(ref, [self.rank])[self.rank]
        cid = self.post(self.rank, {"do": "recv", "key": ("fetched", ref.key), "value": spec,
                                    "what": f"fetch {ref.key} from rank {ref.rank}"})
        self.wait(cid, [self.rank], f"fetch {ref.key}")
        return self.local.store.pop(("fetched", ref.key))

    def run_on(self, ranks, cmd: dict, what: str) -> dict:
        """Post ``cmd`` (a ``run`` on each rank's own thread unless it names
        a lane) to every rank of ``ranks`` and wait for all: {rank: report}."""
        cid = self.new_id()
        for r in dict.fromkeys(ranks):
            self.post(r, dict(cmd, do=cmd.get("do", "run"), id=cid, what=what))
        return self.wait(cid, ranks, what)

    def call(self, fn, *args, ranks=None) -> dict:
        """{rank: ``fn(target, *args)``} from every rank's worker thread (every
        rank of the pool by default), in command order."""
        ranks = self.pool.ranks if ranks is None else ranks
        reps = self.run_on(ranks, {"do": "call", "fn": fn, "args": args},
                           f"call {getattr(fn, '__name__', fn)}")
        return {r: rep["result"] for r, rep in sorted(reps.items())}

    def close(self) -> dict:
        """Stop every worker (each stops its lanes and frees their cuBLAS
        workspaces first): {rank: bytes it sent}."""
        if self.closed:
            return {}
        self.closed = True
        reps = self.run_on(self.pool.ranks, {"do": "stop"}, "stop")
        self._thread.join(self.timeout_s)
        self._out.drain()
        return {r: rep.get("bytes_sent", 0) for r, rep in reps.items()}


class OverRanks:
    """What both pipelines over ranks share: ``work`` (a rank other than the
    controller), ``call_ranks`` (the controller), and the run bracket every
    rank executes: ``begin`` (the store emptied of a failed run's tensors,
    the counters read), ``window`` (the timed run starts: a first call from
    now on is late, kernel launches count) and ``end`` (what the run cost
    this rank), merged on the controller into ``compile_stats`` and the
    result's ``ranks``.  The pipeline sets ``pool``, ``_ctl`` (its
    `Controller`, on the controller's rank), ``ranks`` and
    ``compile_stats``."""

    def work(self) -> None:
        """On a rank of the pool other than its controller: run the
        controller's commands on this rank's stages until it closes the
        pipeline, and every successor built from it on this rank
        (`runtime.elastic.rescale_serving`, whose workers run on threads of
        their own meanwhile).  Raises `RankFailure` when no command came
        within the pool's time limit."""
        if self.pool is None or self._ctl is not None:
            raise RuntimeError("work() runs a rank of a pipeline over ranks other than its "
                               "controller; the controller runs the pipeline")
        Worker(self.pool, self).loop()
        for thread, errors in getattr(self, "_successors", ()):
            thread.join()
            if errors:
                raise errors[0]

    def _work_beside(self, parent) -> None:
        """`work` on a thread of its own, joined by ``parent``'s `work` on
        this rank (this pipeline succeeds ``parent``, whose worker goes on)."""
        errors: list = []

        def run():
            try:
                self.work()
            except Exception as e:
                errors.append(e)
        thread = threading.Thread(target=run, daemon=True, name=f"rank{self.pool.rank}-worker")
        thread.start()
        parent.__dict__.setdefault("_successors", []).append((thread, errors))

    def call_ranks(self, fn, *args) -> dict:
        """{rank: ``fn(pipeline, *args)``} from each rank of the pipeline, on
        its worker thread (``fn`` must pickle by reference: a module-level
        function): the way to read or reset per-process state, such as the
        kernels' launch counts, on every rank."""
        return self._ctl.call(fn, *args, ranks=self.ranks)

    def _check_controller(self) -> None:
        if self._ctl is None:
            raise RuntimeError(f"rank {self.pool.rank} runs its stages' ops: call work(); "
                               f"rank {self.pool.controller} runs the pipeline")

    def _on_begin(self, w, cmd, inputs):
        w.store.clear()                 # a failed run's tensors; PARKED stays
        cs = self.compile_stats
        self._rank_mark = (cs.compiles, cs.misses, cs.late, cs.calls, w.bytes_sent,
                           w.bytes_moved, launch_counts())
        self._rank_launches = self._rank_mark[-1]
        return {}

    def _on_window(self, w, cmd, inputs):
        self.compile_stats.in_window = True
        self._rank_launches = launch_counts()
        return {}

    def _on_end(self, w, cmd, inputs):
        self.compile_stats.in_window = False
        if cmd.get("failed"):
            w.store.clear()
        cs, (c0, m0, l0, k0, b0, v0, _) = self.compile_stats, self._rank_mark
        since = self._rank_launches
        return {"compiles": cs.compiles - c0, "misses": cs.misses - m0, "late": cs.late - l0,
                "calls": cs.calls - k0, "bytes_sent": w.bytes_sent - b0,
                "bytes_moved": w.bytes_moved - v0,
                "launches": {k: v - since.get(k, 0) for k, v in launch_counts().items()}}

    def _bracket(self, body):
        """``begin`` on every rank, ``body()``, ``end`` on every rank (also
        when ``body`` raised); returns (``body()``, {rank: its costs}) after
        adding the other ranks' first calls to ``compile_stats``.  After a
        `PipelineFailure` (a fault with no failover) every command still in
        flight is waited home first, and every rank empties its store; the
        first command that raised on a rank meanwhile is raised instead.
        After any other exception the commands in flight are abandoned
        (`Controller.abandon`) before ``end``."""
        ctl = self._ctl
        ctl.run_on(self.ranks, {"fn": "begin"}, "begin")
        try:
            out = body()
        except PipelineFailure as e:
            errors = ctl.drain()
            ctl.run_on(self.ranks, {"fn": "end", "failed": True}, "end")
            if errors:                  # a rank's own fault, not the simulated one
                raise errors[0] from e
            raise
        except Exception:
            ctl.abandon()
            try:
                ctl.run_on(self.ranks, {"fn": "end"}, "end")
            except Exception:
                pass
            raise
        ends = ctl.run_on(self.ranks, {"fn": "end"}, "end")
        cs = self.compile_stats
        costs = {}
        for r, e in sorted(ends.items()):
            if r != ctl.rank:
                cs.compiles += e["compiles"]
                cs.misses += e["misses"]
                cs.late += e["late"]
                cs.calls += e["calls"]
            costs[r] = {"late": e["late"], "bytes_sent": e["bytes_sent"],
                        "bytes_moved": e["bytes_moved"],
                        "launches": {k: v for k, v in e["launches"].items() if v}}
        return out, costs


"""Continuous-batching serve runtime around a :class:`ServeEngine`.

``ServeEngine`` (engine.py) is call-in/call-out: one caller, one batch, one
blocking round trip.  This module is the serving *process* around it, which
lets one engine sustain interleaved IF/IS/RF/RS traffic with streaming
updates mid-stream:

* **admission**: :meth:`ServeRuntime.submit` appends a request (its own
  semantics flag, ef, k and optional deadline) to a bounded FIFO; a request
  whose deadline already passed is answered with :class:`DeadlineExceeded`
  at once (never silently dropped), and the bound gives callers
  backpressure (:class:`QueueFull`) instead of an unbounded queue;
* **coalescing**: the dispatcher packs the longest run of pending requests
  that share ``(ef, k)`` (semantics are per-row state) into one
  micro-batch, padded to a :data:`~repro_torch.serve.engine.BATCH_BUCKETS`
  size with no-op rows.  Queued rows stay in host memory; a micro-batch's
  vectors, windows and flags go to the card in one copy, and its ids and
  distances come back in one copy;
* **dispatch and completion**: the dispatcher thread runs the search and
  queues the micro-batch with a CUDA event recorded after its result copy;
  the completer thread waits on that event, never on the stream, and
  resolves the futures.  Both threads' work and every write run on the
  dispatcher's stream, in FIFO order.  The port's search loop reads one
  flag back from the card an iteration, so the dispatcher waits out most
  of each search itself and the overlap is small;
* **snapshots**: updates are functional: a write builds a new index (never
  writing into the old one's tensors) and swaps the engine's reference.
  A micro-batch pins the index once at dequeue, so a query admitted before
  a write answers against the pre-write snapshot and one admitted after
  against the post-write snapshot, never a torn mix;
* **fleet health**: :class:`FleetServeMonitor` turns per-shard probe
  timings (the callables of
  :func:`repro_torch.core.sharded.make_shard_probe_fns`) into slow-shard
  advice (:class:`~repro_torch.ft.FleetMonitor`) and a replica plan
  (:func:`~repro_torch.ft.plan_serve_rescale`).

Every row of a search batch is bitwise independent of the rest of the
batch, which makes continuous batching *exact*: however the coalescer
slices the stream, each answer equals a direct ``search_mixed`` call on its
pinned snapshot, bit for bit (``tests/test_torch_serve.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue as _queue
import random
import threading
import time
from concurrent.futures import Future
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import intervals as iv
from repro_torch.ft.elastic import RescalePlan, plan_serve_rescale
from repro_torch.ft.straggler import FleetMonitor, StragglerConfig
from repro_torch.serve.engine import ServeEngine, search_padded

_LAT_RESERVOIR_CAP = 4096


class LatencyReservoir:
    """Fixed-size uniform sample of a latency stream (Vitter's Algorithm R).

    The first ``cap`` samples are kept verbatim; after that each new sample
    replaces a uniformly random held slot with probability ``cap / seen``,
    which keeps the held set a uniform sample of everything offered while
    host memory stays bounded.  The RNG is seeded, so repeated runs report
    identical percentiles."""

    def __init__(self, cap: int = _LAT_RESERVOIR_CAP, *, seed: int = 0):
        if cap <= 0:
            raise ValueError(f"reservoir cap must be positive, got {cap}")
        self.cap = cap
        self.seen = 0
        self._rng = random.Random(seed)
        self._sample: list[float] = []

    def offer(self, x: float) -> None:
        self.seen += 1
        if len(self._sample) < self.cap:
            self._sample.append(x)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.cap:
                self._sample[j] = x

    def extend(self, xs) -> None:
        for x in xs:
            self.offer(x)

    def __len__(self) -> int:
        return len(self._sample)

    def __iter__(self):
        return iter(self._sample)


class DeadlineExceeded(Exception):
    """A request's deadline passed before it could be dispatched.

    Raised *into the request's future*, at admission (deadline already past)
    and at dequeue (expired while queued): an expired request is always
    answered with this error, never silently dropped."""


class QueueFull(Exception):
    """Admission bound hit: the caller must shed load or retry later."""


class ServeReply(NamedTuple):
    """One request's answer and the snapshot it answered against."""

    ids: np.ndarray        # (k,) int32 node ids, -1 padded
    dist: np.ndarray       # (k,) f32 squared distances
    latency_s: float       # submit → resolution wall time
    index: Any             # the pinned UGIndex snapshot


@dataclasses.dataclass
class RuntimeConfig:
    max_batch: int = 256     # coalescer cap (one micro-batch's request count)
    max_queue: int = 4096    # admission bound (pending requests + writes)
    max_inflight: int = 2    # dispatched-but-unresolved micro-batches
    default_ef: int = 64
    default_k: int = 10


@dataclasses.dataclass
class _Query:
    q_v: np.ndarray          # (d,) f32, host memory
    q_int: np.ndarray        # (2,) f32, host memory
    flag: int                # FLAG_IF | FLAG_IS
    ef: int
    k: int
    deadline: float | None   # absolute clock() time, None = no deadline
    future: Future
    t_submit: float


@dataclasses.dataclass
class _Write:
    kind: str                # "upsert" | "remove"
    payload: tuple
    future: Future
    t_submit: float


def _host_row(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32).reshape(-1)


class ServeRuntime:
    """Continuous-batching loop over a :class:`ServeEngine`.

    Two execution modes share all of the machinery:

    * **threaded**: :meth:`start` spawns the dispatcher and completer
      threads; :meth:`stop` drains the queue and joins them.  The serving
      mode (``launch/serve.py --async``, ``bench_serve``).
    * **inline**: :meth:`run_until_idle` pumps the same dequeue → coalesce →
      dispatch → complete pipeline on the caller's thread until the queue is
      empty: deterministic and thread-free.

    The engine's ``search_backend``/``search_width`` are honoured; writes go
    through ``ServeEngine.upsert``/``remove`` (its single-read chunk plan and
    bucketed batches)."""

    def __init__(self, engine: ServeEngine, config: RuntimeConfig = RuntimeConfig(), *,
                 clock=time.monotonic):
        if engine.index is None:
            raise ValueError("engine has no index attached")
        self.engine = engine
        self.cfg = config
        self.clock = clock
        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._inflight: _queue.Queue = _queue.Queue(maxsize=config.max_inflight)
        self._dispatcher: threading.Thread | None = None
        self._completer: threading.Thread | None = None
        self._stopping = False
        self._stats_lock = threading.Lock()
        self._latencies = LatencyReservoir()
        self._completed = 0
        self._rejected = 0
        self._writes = 0
        # QPS counts active serving windows only: start()/stop() pairs plus
        # the time inside run_until_idle(), never construction or idle time.
        self._t_start: float | None = None
        self._wall_accum = 0.0

    # ------------------------------------------------------------ admission
    def submit(self, q_v, q_int, sem, *, ef: int | None = None, k: int | None = None,
               deadline: float | None = None) -> Future:
        """Admit one query; returns a future resolving to a :class:`ServeReply`.

        ``sem`` is a :class:`~repro_torch.core.Semantics` or a raw flag int;
        ``deadline`` is an absolute ``clock()`` time.  An expired request is
        rejected at once (its future carries :class:`DeadlineExceeded`); a
        full queue raises :class:`QueueFull` here, so the caller sees
        backpressure.  The row is copied to host memory (a card tensor costs
        a copy back here; keep request rows on the host)."""
        fut: Future = Future()
        now = self.clock()
        # plain Python, no tensor op: a torch call would release the
        # interpreter lock to the dispatcher at every admission
        flag = sem.flag if isinstance(sem, iv.Semantics) else int(sem)
        if flag not in (iv.FLAG_IF, iv.FLAG_IS):
            raise ValueError(f"sem flag must be FLAG_IF ({iv.FLAG_IF}) or FLAG_IS "
                             f"({iv.FLAG_IS}), got {flag}")
        if deadline is not None and deadline <= now:
            self._reject(fut, DeadlineExceeded(
                f"deadline {deadline:.3f} already passed at admission ({now:.3f})"))
            return fut
        self._enqueue(_Query(
            _host_row(q_v), _host_row(q_int), flag,
            int(ef if ef is not None else self.cfg.default_ef),
            int(k if k is not None else self.cfg.default_k),
            deadline, fut, now))
        return fut

    def submit_upsert(self, x, intervals) -> Future:
        """Admit a streaming insert; the future resolves to the inserted
        count.  Its FIFO position is its snapshot boundary: queries admitted
        before it answer pre-write, queries admitted after answer
        post-write."""
        fut: Future = Future()
        self._enqueue(_Write("upsert", (x, intervals), fut, self.clock()))
        return fut

    def submit_remove(self, ids, *, repair: bool = True) -> Future:
        """Admit a streaming delete; the future resolves to the removed count."""
        fut: Future = Future()
        self._enqueue(_Write("remove", (ids, repair), fut, self.clock()))
        return fut

    def _enqueue(self, item) -> None:
        with self._cv:
            if self._stopping:
                raise RuntimeError("runtime is stopping; admission closed")
            if len(self._pending) >= self.cfg.max_queue:
                raise QueueFull(f"admission queue at bound {self.cfg.max_queue}")
            self._pending.append(item)
            self._cv.notify()

    def _reject(self, fut: Future, exc: Exception) -> None:
        with self._stats_lock:
            self._rejected += 1
        fut.set_exception(exc)

    # ----------------------------------------------------------- coalescing
    def _next_work(self, block: bool):
        """Dequeue the next unit of work in FIFO order: one write, or the
        longest head run of queries sharing ``(ef, k)``, capped at
        ``max_batch``.  ``None`` when idle (inline mode) or stopped."""
        with self._cv:
            while not self._pending:
                if not block or self._stopping:
                    return None
                self._cv.wait()
            head = self._pending[0]
            if isinstance(head, _Write):
                return self._pending.popleft()
            key = (head.ef, head.k)
            batch = []
            while (self._pending and isinstance(self._pending[0], _Query)
                   and (self._pending[0].ef, self._pending[0].k) == key
                   and len(batch) < self.cfg.max_batch):
                batch.append(self._pending.popleft())
            return batch

    def _launch(self, batch: list[_Query]):
        """Expire dead requests, pin the snapshot, pack and pad the
        micro-batch, search, and start the copy of its answers to host
        memory; the completer waits for it."""
        now = self.clock()
        live = []
        for r in batch:
            if r.deadline is not None and r.deadline <= now:
                self._reject(r.future, DeadlineExceeded(
                    f"deadline expired in queue ({now - r.t_submit:.3f}s after admission)"))
            else:
                live.append(r)
        if not live:
            return None
        index = self.engine.index           # pin the snapshot at dequeue time
        dev = index.device
        ef, k = live[0].ef, live[0].k
        B, d = len(live), live[0].q_v.shape[0]
        # vectors | window | flag in one host buffer: one copy to the card
        rows = np.empty((B, d + 3), np.float32)
        rows[:, :d] = np.stack([r.q_v for r in live])
        rows[:, d:d + 2] = np.stack([r.q_int for r in live])
        rows[:, d + 2] = [r.flag for r in live]
        packed = torch.from_numpy(rows).to(dev)
        res = search_padded(index, packed[:, :d].contiguous(), packed[:, d:d + 2].contiguous(),
                            packed[:, d + 2].to(torch.int32), ef=ef, k=k,
                            backend=self.engine.search_backend, width=self.engine.search_width)
        # ids and distance bits in one tensor: one copy back
        out = torch.stack([res.ids.to(torch.int32), res.dist.view(torch.int32)])
        done = None
        if out.is_cuda:
            host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            out = host
        return live, out, done, index

    def _complete(self, inflight) -> None:
        """Wait for one micro-batch's answers and resolve its futures."""
        live, out, done, index = inflight
        if done is not None:
            done.synchronize()              # the search and its copy are done
        ids = out[0].numpy()
        dist = out[1].numpy().view(np.float32)
        now = self.clock()
        lats = []
        for i, r in enumerate(live):
            lat = now - r.t_submit
            lats.append(lat)
            r.future.set_result(ServeReply(ids[i], dist[i], lat, index))
        with self._stats_lock:
            self._completed += len(live)
            self._latencies.extend(lats)

    def _apply_write(self, w: _Write) -> None:
        """Run one write through the engine.  ``ServeEngine.upsert/remove``
        build the new index functionally and swap ``engine.index``, one
        reference store, so a dequeue sees the old or the new snapshot."""
        try:
            if w.kind == "upsert":
                x, ivs = w.payload
                out = self.engine.upsert(None, ivs, x=x)
            else:
                ids, repair = w.payload
                out = self.engine.remove(ids, repair=repair)
            with self._stats_lock:
                self._writes += 1
            w.future.set_result(out)
        except Exception as e:  # noqa: BLE001  (surfaced to the submitter)
            w.future.set_exception(e)

    # ------------------------------------------------------------ execution
    def run_until_idle(self) -> int:
        """Inline mode: pump dequeue → dispatch → complete until the queue is
        empty.  Returns the number of work units processed; the pump's wall
        time counts toward the QPS window."""
        done = 0
        t0 = self.clock()
        try:
            while True:
                work = self._next_work(block=False)
                if work is None:
                    return done
                done += 1
                if isinstance(work, _Write):
                    self._apply_write(work)
                else:
                    inflight = self._launch(work)
                    if inflight is not None:
                        self._complete(inflight)
        finally:
            with self._stats_lock:
                self._wall_accum += self.clock() - t0

    @staticmethod
    def _fail(batch, exc: Exception) -> None:
        for r in batch:
            if not r.future.done():
                r.future.set_exception(exc)

    def _dispatch_loop(self) -> None:
        while True:
            work = self._next_work(block=True)
            if work is None:
                break
            if isinstance(work, _Write):
                self._apply_write(work)
                continue
            try:
                inflight = self._launch(work)
            except Exception as e:  # noqa: BLE001  (answered, the loop goes on)
                self._fail(work, e)
                continue
            if inflight is not None:
                self._inflight.put(inflight)   # backpressure at max_inflight
        self._inflight.put(None)               # completer shutdown

    def _complete_loop(self) -> None:
        while True:
            inflight = self._inflight.get()
            if inflight is None:
                break
            try:
                self._complete(inflight)
            except Exception as e:  # noqa: BLE001  (answered, the loop goes on)
                self._fail(inflight[0], e)

    def start(self) -> "ServeRuntime":
        if self._dispatcher is not None:
            raise RuntimeError("runtime already started")
        with self._stats_lock:
            self._t_start = self.clock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name="serve-complete", daemon=True)
        self._dispatcher.start()
        self._completer.start()
        return self

    def stop(self) -> None:
        """Drain the queue, then join both threads."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join()
            self._completer.join()
            self._dispatcher = self._completer = None
        with self._stats_lock:
            if self._t_start is not None:
                self._wall_accum += self.clock() - self._t_start
                self._t_start = None
        # admission reopens: a stopped runtime can be started again
        self._stopping = False

    def __enter__(self) -> "ServeRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Serving counters and latency percentiles over the active windows.

        ``qps`` is completed requests over the *active* wall time: closed
        start/stop windows, run_until_idle() pumps and the open start()
        window, if any.  Percentiles come from a bounded uniform reservoir
        of the per-request latencies."""
        with self._stats_lock:
            lats = sorted(self._latencies)
            completed = self._completed
            rejected = self._rejected
            writes = self._writes
            wall = self._wall_accum
            if self._t_start is not None:
                wall += self.clock() - self._t_start
        return {
            "completed": completed,
            "rejected": rejected,
            "writes": writes,
            "qps": completed / max(wall, 1e-9),
            "p50_ms": 1e3 * _pctl(lats, 0.50),
            "p99_ms": 1e3 * _pctl(lats, 0.99),
        }


def count_pinned_matches(replies: Sequence[ServeReply], q_v: torch.Tensor, q_int: torch.Tensor,
                         flags: torch.Tensor, *, ef: int, k: int, backend: str | None = None,
                         width: int = 4) -> int:
    """How many replies equal, bitwise (ids and distance bits), a direct
    padded ``search_mixed`` on the snapshot each reply pinned.  ``q_v``,
    ``q_int`` and ``flags`` hold request ``i``'s row at ``i``, on the
    snapshots' device; a snapshot's requests are searched as one batch."""
    groups: dict[int, tuple[Any, list[int]]] = {}
    for i, r in enumerate(replies):
        groups.setdefault(id(r.index), (r.index, []))[1].append(i)
    same = 0
    for index, sel in groups.values():
        sel_t = torch.as_tensor(sel, device=q_v.device)
        ref = search_padded(index, q_v[sel_t], q_int[sel_t], flags[sel_t], ef=ef, k=k,
                            backend=backend, width=width)
        ids, dist = ref.ids.cpu().numpy(), ref.dist.cpu().numpy()
        same += sum(np.array_equal(replies[i].ids, ids[j])
                    and np.array_equal(replies[i].dist.view(np.int32), dist[j].view(np.int32))
                    for j, i in enumerate(sel))
    return same


def _pctl(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest element with at least ``q`` of
    the sample at or below it, i.e. index ``ceil(q*n) - 1``."""
    if not sorted_xs:
        return 0.0
    n = len(sorted_xs)
    i = min(max(math.ceil(q * n) - 1, 0), n - 1)
    return sorted_xs[i]


# --------------------------------------------------------------------------
# Fleet health: straggler probing and replica planning (sharded serving)
# --------------------------------------------------------------------------
class FleetServeMonitor:
    """Per-shard step timing → slow-shard mitigation and replica planning.

    One :class:`~repro_torch.ft.StepTimer` slot a shard.  :meth:`probe`
    times one local search step of each shard (any callables of
    ``(q_v, q_int, sem_flags)``; a sharded index's come from
    :func:`repro_torch.core.sharded.make_shard_probe_fns`) and records the
    fleet; :meth:`report` turns the timings
    into straggler ids, per-shard advice and
    :func:`~repro_torch.ft.plan_serve_rescale` replica plans."""

    def __init__(self, n_shards: int, n_devices: int, cfg: StragglerConfig = StragglerConfig()):
        if n_devices % n_shards:
            raise ValueError(f"{n_devices} devices not divisible by {n_shards} shards")
        self.n_shards = n_shards
        self.n_devices = n_devices
        self.fleet = FleetMonitor(n_shards, cfg)

    def record(self, shard: int, seconds: float) -> None:
        self.fleet.record(shard, seconds)

    def probe(self, shard_fns, q_v, q_int, sem_flags) -> list[float]:
        """Time one local-search step a shard, each ended by a synchronize
        where the card has work, and record the fleet."""
        times = []
        for s, fn in enumerate(shard_fns):
            t0 = time.perf_counter()
            fn(q_v, q_int, sem_flags)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            times.append(dt)
            self.fleet.record(s, dt)
        return times

    def report(self) -> dict:
        """Fleet health snapshot: stragglers, mitigations, replica plans."""
        slow = self.fleet.stragglers()
        per_shard = self.n_devices // self.n_shards
        healthy = self.n_devices - len(slow) * per_shard
        plan = plan_serve_rescale(self.n_devices, self.n_shards)
        degraded: RescalePlan | None = None
        if slow and healthy >= self.n_shards:
            # each straggling shard's device group counts as lost capacity:
            # the plan for what remains is what a launcher would rescale to
            degraded = plan_serve_rescale(healthy, self.n_shards)
        return {
            "stragglers": slow,
            "recommendations": self.fleet.recommendations(),
            "plan": plan,
            "degraded_plan": degraded,
        }

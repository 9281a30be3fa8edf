"""Async admission for the FIM query surface: bounded queue, continuous
greedy-LPT batching, version-stamped answers (DESIGN.md §11).

``ServingFrontend`` is the production front end the synchronous
``StreamQueryService`` adapts down from: concurrent clients ``submit``
:class:`~repro_torch.serving.ItemsetQuery` objects into a bounded admission queue
and get a :class:`Ticket` back; a drain worker collects queued queries until
either the batch-size or the deadline trigger fires, packs the drained batch
onto answer slots with the paper's greedy-LPT balance objective (the same
``core.partitioners`` call that packs equivalence classes onto executors),
and answers every query from **one** immutable window snapshot — so each
answer is bit-identical to the same query answered synchronously at that
``window_version``, which ``loadgen.verify_storm`` re-checks by checksum.

Backpressure: a full queue either *sheds* (``QueryShed`` raised to the
client immediately) or *blocks* the submitter until space frees, per
``AdmissionConfig.policy``.  Liveness: the writer beats a
``training.fault_tolerance.Heartbeat`` on every ingest; with
``stall_timeout_s`` set, a stalled miner is detected and reported
(``WriterStalledError`` out of :meth:`ServingFrontend.wait_for_version`,
``n_stalls`` in metrics) instead of readers hanging forever.

Threads and the card: the writer thread that calls :meth:`ServingFrontend.
ingest` launches the miner's kernels (K4 per push, K2 per expansion), so
``ingest`` makes the miner's device the current CUDA device of that thread
(the current device is per thread).  The kernel library's first load is
serialized by its own lock (``kernels._build.library``).  Readers never
touch the card: they answer from host ``WindowSnapshot``s only.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..streaming import StreamingMiner, WindowResult, restore_miner
from ..training.fault_tolerance import (Heartbeat, HeartbeatMonitor,
                                        WriterStalledError)
from .cache import VersionedCache
from .metrics import ServingMetrics, now
from .snapshot import WindowSnapshot, answer_query
from .stream_query import ItemsetQuery, pack_queries

__all__ = ["AdmissionConfig", "QueryShed", "Ticket", "ServingFrontend"]


class QueryShed(RuntimeError):
    """Backpressure: the admission queue was full and the policy shed the
    query (or a blocking submit timed out waiting for space)."""


@dataclasses.dataclass
class AdmissionConfig:
    """Knobs of the serving front end."""

    max_queue: int = 256          # bounded admission queue capacity
    policy: str = "block"         # full-queue policy: "block" | "shed"
    max_batch: int = 32           # drain trigger: this many queued...
    max_wait_s: float = 0.002     # ...or the oldest query has waited this long
    n_slots: int = 4              # greedy-LPT answer slots per drained batch
    block_timeout_s: float = 5.0  # block policy: max wait for space, then shed
    stall_timeout_s: Optional[float] = None  # writer heartbeat deadline
    keep_versions: int = 8        # snapshot history depth (verification/pinning)

    def __post_init__(self):
        if self.policy not in ("block", "shed"):
            raise ValueError(f"policy must be 'block' or 'shed', "
                             f"got {self.policy!r}")
        if self.max_queue < 1 or self.max_batch < 1 or self.n_slots < 1:
            raise ValueError("max_queue, max_batch and n_slots must be >= 1")


class Ticket:
    """One admitted query: timestamps, future-style result, version stamp."""

    __slots__ = ("query", "t_enqueue", "t_drain", "t_answer", "version",
                 "answer", "error", "cache_hit", "_done")

    def __init__(self, query: ItemsetQuery):
        self.query = query
        self.t_enqueue = now()
        self.t_drain: Optional[float] = None
        self.t_answer: Optional[float] = None
        self.version: Optional[int] = None
        self.answer = None
        self.error: Optional[BaseException] = None
        self.cache_hit = False
        self._done = threading.Event()

    def _complete(self, answer, version: int, cache_hit: bool) -> None:
        self.answer, self.version, self.cache_hit = answer, version, cache_hit
        self.t_answer = now()
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self.error = error
        self.t_answer = now()
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the answer; returns ``(answer, window_version)``.

        Raises the answering error if the query failed, and ``TimeoutError``
        if no answer lands in ``timeout`` seconds — a bounded wait, so a
        reader can never hang forever on a dead front end.
        """
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query qid={self.query.qid} unanswered after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.answer, self.version


class ServingFrontend:
    """Continuous-batching query front end over one ``StreamingMiner``.

    Writer side: one thread calls :meth:`ingest` (window slide + snapshot
    publication + heartbeat).  Reader side: any number of threads call
    :meth:`submit` / ``Ticket.result``.  The drain worker is internal.
    """

    def __init__(self, miner: StreamingMiner,
                 config: Optional[AdmissionConfig] = None,
                 auto_start: bool = True):
        self.miner = miner
        self.config = config or AdmissionConfig()
        self.cache = VersionedCache()
        self.metrics = ServingMetrics()
        self.heartbeat = Heartbeat()
        self.monitor = (HeartbeatMonitor(
            self.heartbeat, self.config.stall_timeout_s,
            on_stall=lambda _r: self.metrics.record_stall(), name="miner")
            if self.config.stall_timeout_s else None)
        self._history: "collections.OrderedDict[int, WindowSnapshot]" = \
            collections.OrderedDict()
        # serve the window the miner already holds (empty for a fresh miner,
        # the restored window for a checkpoint restore) — a restarted server
        # answers before its first live slide
        self._snapshot = self._publish(miner.mine_window())
        self._cond = threading.Condition()
        self._queue: "collections.deque[Ticket]" = collections.deque()
        self._running = False
        self._worker: Optional[threading.Thread] = None
        self.last_pack_stats: Optional[dict] = None
        if auto_start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._worker = threading.Thread(target=self._drain_loop,
                                        name="serving-drain", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        """Stop the drain worker; fails still-queued tickets (readers are
        released with an error, never left hanging)."""
        with self._cond:
            self._running = False
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None
        for t in pending:
            t._fail(RuntimeError("serving frontend stopped"))

    def __enter__(self) -> "ServingFrontend":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- writer side ---------------------------------------------------------

    def _publish(self, result: WindowResult) -> WindowSnapshot:
        snap = WindowSnapshot.from_result(result)
        self._history[snap.version] = snap
        while len(self._history) > self.config.keep_versions:
            self._history.popitem(last=False)
        self._snapshot = snap          # atomic publication point
        self.cache.advance(snap.version)
        return snap

    def ingest(self, batch: Sequence[Sequence[int]]) -> WindowResult:
        """One window slide: advance the miner (on the miner's device, made
        current on the calling thread), publish the new snapshot, beat the
        liveness heartbeat."""
        dev = self.miner.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            result = self.miner.advance(batch)
        snap = self._publish(result)
        self.heartbeat.beat(snap.version)
        return result

    # -- reader side ---------------------------------------------------------

    @property
    def snapshot(self) -> WindowSnapshot:
        return self._snapshot

    @property
    def window_version(self) -> int:
        return self._snapshot.version

    @property
    def writer_stalled(self) -> bool:
        return self.monitor.check() if self.monitor is not None else False

    def snapshot_at(self, version: int) -> Optional[WindowSnapshot]:
        """A retained historical snapshot (None once aged out) — the bench's
        per-version verification oracle."""
        return self._history.get(int(version))

    def wait_for_version(self, version: int, timeout: Optional[float] = None,
                         poll_s: float = 0.005) -> WindowSnapshot:
        """Block until the published window reaches ``version``.

        Raises ``WriterStalledError`` as soon as the heartbeat monitor
        declares the writer stalled (this is the reported-not-hanging path)
        and ``TimeoutError`` after ``timeout`` seconds regardless.
        """
        deadline = None if timeout is None else now() + timeout
        while True:
            snap = self._snapshot
            if snap.version >= version:
                return snap
            if self.monitor is not None:
                self.monitor.assert_alive()
            if deadline is not None and now() > deadline:
                raise TimeoutError(f"window version {version} not reached "
                                   f"(at {snap.version})")
            time.sleep(poll_s)

    def submit(self, query: ItemsetQuery) -> Ticket:
        """Admit one query; returns its :class:`Ticket`.

        Full queue: policy "shed" raises :class:`QueryShed` immediately;
        policy "block" waits up to ``block_timeout_s`` for space, then
        sheds.  Both outcomes are counted in metrics.
        """
        ticket = Ticket(query)
        with self._cond:
            if not self._running:
                raise RuntimeError("serving frontend is not running")
            if len(self._queue) >= self.config.max_queue:
                if self.config.policy == "shed":
                    self.metrics.record_shed()
                    raise QueryShed(f"admission queue full "
                                    f"({self.config.max_queue}); qid="
                                    f"{query.qid} shed")
                deadline = now() + self.config.block_timeout_s
                while len(self._queue) >= self.config.max_queue:
                    remaining = deadline - now()
                    if remaining <= 0 or not self._running:
                        self.metrics.record_shed()
                        raise QueryShed(
                            f"blocked submit timed out after "
                            f"{self.config.block_timeout_s}s; qid="
                            f"{query.qid} shed")
                    self._cond.wait(remaining)
            self._queue.append(ticket)
            self._cond.notify_all()
        return ticket

    def submit_many(self, queries: Sequence[ItemsetQuery]) -> List[Ticket]:
        return [self.submit(q) for q in queries]

    # -- drain worker --------------------------------------------------------

    def _drain_loop(self) -> None:
        cfg = self.config
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait(0.05)
                    if self.monitor is not None:
                        self.monitor.check()   # latch + count a writer stall
                if not self._running and not self._queue:
                    return
                # continuous batching: drain when max_batch queries are
                # waiting or the oldest has aged past the deadline,
                # whichever first
                deadline = self._queue[0].t_enqueue + cfg.max_wait_s
                while (self._running and len(self._queue) < cfg.max_batch
                       and now() < deadline):
                    self._cond.wait(max(deadline - now(), 1e-4))
                batch = [self._queue.popleft()
                         for _ in range(min(len(self._queue), cfg.max_batch))]
                self._cond.notify_all()        # wake blocked submitters
            if batch:
                self._answer_batch(batch)

    def _answer_batch(self, tickets: List[Ticket]) -> None:
        t_drain = now()
        for t in tickets:
            t.t_drain = t_drain
        snap = self._snapshot              # ONE reference read per batch
        try:
            assign, stats = pack_queries([t.query for t in tickets],
                                         self.config.n_slots,
                                         max(len(snap.itemsets), 1))
        except Exception as e:             # malformed batch: release readers
            for t in tickets:
                t._fail(e)
                self.metrics.record_error()
            return
        stats["window_version"] = snap.version
        self.last_pack_stats = stats
        self.metrics.record_batch(len(tickets))
        for slot in range(self.config.n_slots):
            for qi in np.nonzero(assign == slot)[0]:
                t = tickets[int(qi)]
                try:
                    answer, hit = answer_query(snap, t.query, cache=self.cache)
                    t._complete(answer, snap.version, hit)
                    self.metrics.record_answer(t.t_enqueue, t.t_drain,
                                               t.t_answer, cache_hit=hit)
                except Exception as e:
                    t._fail(e)
                    self.metrics.record_error()

    # -- restore -------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, directory: str, mesh=None,
                        *, backend: Optional[str] = None,
                        shard: Optional[str] = None,
                        config: Optional[AdmissionConfig] = None,
                        auto_start: bool = True,
                        device: DeviceLike = None,
                        ) -> Tuple["ServingFrontend", int]:
        """Rebuild a serving front end from a ``streaming/persist.py``
        checkpoint (this package's or the reference's) on ``device``
        (``None`` = CUDA): the restored miner re-expands its window and the
        frontend answers from it immediately (a restarted server needs no
        live slide before its first answer).  Returns
        ``(frontend, completed_slides)``.
        """
        miner, completed = restore_miner(directory, mesh=mesh,
                                         backend=backend, shard=shard,
                                         keep_transactions=False,
                                         device=device)
        return cls(miner, config=config, auto_start=auto_start), completed

"""Deterministic query storms + the answer-checksum verification oracle.

Shared by the ``--serve`` drivers (``launch.stream`` / ``launch.serve``):
:func:`query_mix` builds a seeded,
heterogeneous query population (top-k probes of wildly different ``k``,
rule scans at several ``min_conf``), :func:`run_storm` fires it from
concurrent client threads at the front end while the miner slides windows
underneath, and :func:`verify_storm` replays every served answer
*synchronously* against the retained snapshot of the exact
``window_version`` it was stamped with — any checksum divergence raises,
which is the bit-identity gate of DESIGN.md §11.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .admission import QueryShed, ServingFrontend
from .snapshot import answer_query
from .stream_query import ItemsetQuery

__all__ = ["query_mix", "run_storm", "answer_checksum", "verify_storm"]


def query_mix(n_queries: int, seed: int = 0, *,
              rules_frac: float = 0.25,
              ks: Sequence[int] = (1, 5, 20, 100),
              min_lens: Sequence[int] = (1, 2),
              min_confs: Sequence[float] = (0.6, 0.8, 0.9)
              ) -> List[ItemsetQuery]:
    """A seeded heterogeneous query population (deterministic in its args)."""
    rng = np.random.default_rng(seed)
    out = []
    for qid in range(n_queries):
        if rng.random() < rules_frac:
            out.append(ItemsetQuery(
                qid=qid, kind="rules",
                k=int(rng.choice(ks)),
                min_conf=float(rng.choice(min_confs))))
        else:
            out.append(ItemsetQuery(
                qid=qid, kind="topk",
                k=int(rng.choice(ks)),
                min_len=int(rng.choice(min_lens))))
    return out


def run_storm(frontend: ServingFrontend, queries: Sequence[ItemsetQuery],
              n_clients: int = 4, timeout_s: float = 60.0,
              pace_s: float = 0.0) -> dict:
    """Fire ``queries`` at the front end from ``n_clients`` threads.

    Queries are dealt round-robin to clients; each client submits and blocks
    on its ticket (the open-loop arrival process is the admission queue's
    job).  Returns per-query outcomes:
    ``{"answers": {qid: (answer, version)}, "shed": [qid...],
    "errors": {qid: repr}}``.
    """
    answers: Dict[int, tuple] = {}
    shed: List[int] = []
    errors: Dict[int, str] = {}
    lock = threading.Lock()

    def client(cid: int):
        for q in list(queries)[cid::n_clients]:
            try:
                ticket = frontend.submit(q)
                ans, version = ticket.result(timeout=timeout_s)
                with lock:
                    answers[q.qid] = (ans, version)
            except QueryShed:
                with lock:
                    shed.append(q.qid)
            except Exception as e:          # surfaced per query, never hung
                with lock:
                    errors[q.qid] = repr(e)
            if pace_s:
                time.sleep(pace_s)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s + 10.0)
    return {"answers": answers, "shed": sorted(shed), "errors": errors}


def answer_checksum(answer) -> str:
    """Stable content hash of one answer payload (tuples of ints/floats —
    ``repr`` is canonical for them)."""
    return hashlib.sha256(repr(answer).encode()).hexdigest()[:16]


def verify_storm(frontend: ServingFrontend,
                 queries: Sequence[ItemsetQuery],
                 outcome: dict) -> dict:
    """Replay every served answer synchronously at its stamped version.

    For each answered query, the retained :class:`WindowSnapshot` of that
    exact ``window_version`` is queried directly (no cache, no batching)
    and the checksums must match — a divergence means the batched path
    served a torn or wrong-version answer, and raises.  Versions already
    aged out of the history are reported, not silently skipped.
    """
    by_qid = {q.qid: q for q in queries}
    verified = 0
    unverifiable = []
    digest = hashlib.sha256()
    for qid in sorted(outcome["answers"]):
        answer, version = outcome["answers"][qid]
        snap = frontend.snapshot_at(version)
        if snap is None:
            unverifiable.append(qid)
            continue
        direct, _ = answer_query(snap, by_qid[qid], cache=None)
        got, want = answer_checksum(answer), answer_checksum(direct)
        if got != want:
            raise RuntimeError(
                f"serving divergence: qid={qid} at window_version={version} "
                f"answered {got} batched vs {want} direct — the batched "
                f"path is not bit-identical with the synchronous path")
        digest.update(f"{qid}:{version}:{got};".encode())
        verified += 1
    return {"verified": verified,
            "unverifiable": unverifiable,
            "checksum": digest.hexdigest()[:16],
            "identical": True}

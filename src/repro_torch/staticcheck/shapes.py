"""Layer 3 — the steady-state audit of the mining path (the reference's
``staticcheck/shapes.py``), on the card.

The reference holds a warm mine level and a warm stream slide to three
runtime rules under ``jax.log_compiles`` and ``jax.transfer_guard``.  Here
they read:

    SH001  nothing is built or newly allocated after warm-up: the audited
           region triggers no build or reload of the kernel library
           (``kernels._build``), and the caching allocator's
           ``segment.all.allocated`` and ``num_alloc_retries`` do not grow
           (a shape that escaped the bucket ladder shows up on the card as a
           new segment).  The port calls no ``torch.compile`` under
           ``src/repro_torch/`` (checked statically, :func:`compile_findings`),
           so an XLA-style recompile has no other counterpart.
    SH002  no undeclared host sync: every synchronising CUDA call in an
           audited level and slide, counted by
           ``torch.cuda.set_sync_debug_mode("warn")`` and attributed to its
           source line, is a site of :data:`SYNC_BUDGET` (the line carries
           that site's ``# staticcheck: sync=`` marker), and each site's count
           equals its declared one exactly.  A host-to-device copy that
           waits shows up in the same count and is declared the same way.
           That mode "does not yet detect all synchronizing operations"
           (torch's words; ``torch.cuda.Event.synchronize`` is one it
           misses), so the audit also reads what the card really
           synchronised on: ``torch.profiler``'s CUDA runtime calls
           ``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
           ``cudaEventSynchronize``, and each device-to-host
           ``cudaMemcpy*`` that no such call follows (a copy and its wait
           are one sync), cut into levels and slides by
           ``record_function`` ranges at the same marks.  That count may
           not exceed the total of the unit's :data:`SYNC_BUDGET` sites.
    SH003  every recorded ``level_padding`` entry sits on a rung of
           ``core.engine.bucket_size``.

``audit_mine`` runs batch ``mine()`` twice and audits the second (warm) run
level by level; ``audit_streaming`` fills the window, runs warm-up slides
over a periodic stream and audits >= 5 more.  On the host (``device="cpu"``)
only SH003 and the static part of SH001 can fire; the summary says so.
``check_shape_fixture`` is the must-fail self-test: one finding of each
rule on the card, SH003 on the host; ``check_card_sync_fixture`` makes one
sync the warn mode misses inside a level, which only the profiler's count
finds (on the host it is not counted).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import warnings
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .report import Finding

__all__ = ["SyncSite", "SYNC_BUDGET", "declared_syncs", "budget_total",
           "CardEvent", "card_events", "cut_card_syncs", "cut_card_slides",
           "card_sync_findings", "audit_mine", "audit_streaming",
           "check_shape_fixture", "check_card_sync_fixture",
           "compile_findings", "SHAPE_FIXTURES"]


@dataclasses.dataclass(frozen=True)
class SyncSite:
    """One host sync the mining path makes by design: the module that makes
    it (under ``src/``), the unit of work it is counted per, how many times
    per unit, and what crosses."""

    path: str
    unit: str
    count: int
    what: str


# Every host sync the mining path is declared to make, by site; each site's
# source line carries ``# staticcheck: sync=<site>`` (its file:line is read
# off the source, ``declared_syncs``).  Units: a "level" is one
# ``Engine.expand`` on one device; a "co-occurrence count" one K4 count of
# words uploaded for it (mine()'s level-1 frontier, a push's new block and,
# once the window is full, its evicted block); a "push" one ring write.  The
# mesh units are declared for the lint; Layer 2 holds their collectives.
SYNC_BUDGET: Dict[str, SyncSite] = {
    "engine.pairs_upload": SyncSite(
        "repro_torch/core/engine.py", "level", 1,
        "the level's padded (3, Qb) int32 pair block, uploaded"),
    "engine.mask_supports": SyncSite(
        "repro_torch/core/engine.py", "level", 1,
        "the survivors' mask and supports, read back"),
    "engine.gather_upload": SyncSite(
        "repro_torch/core/engine.py", "level without compaction", 1,
        "the survivor rows' indices, uploaded for the row gather"),
    "device.words_upload": SyncSite(
        "repro_torch/device.py", "co-occurrence count", 1,
        "the counted words, uploaded"),
    "triangular.counts_readback": SyncSite(
        "repro_torch/core/triangular.py", "co-occurrence count", 1,
        "K4's (N, N) counts, copied into the host matrix"),
    "window.block_upload": SyncSite(
        "repro_torch/streaming/window.py", "push", 1,
        "the admitted block's words, uploaded into the ring's span"),
    "sharded.pairs_upload": SyncSite(
        "repro_torch/core/engine.py", "sharded level", 1,
        "this rank's padded pair block, uploaded"),
    "sharded.supports_gather": SyncSite(
        "repro_torch/core/engine.py", "sharded level", 1,
        "every rank's supports (all-gathered over the pair axis), read back"),
    "tidsharded.pairs_upload": SyncSite(
        "repro_torch/core/engine.py", "tidsharded level", 1,
        "the level's padded pair block, uploaded"),
    "tidsharded.mask_supports": SyncSite(
        "repro_torch/core/engine.py", "tidsharded level", 1,
        "the mask and the all-reduced supports, read back"),
    "grid.pairs_upload": SyncSite(
        "repro_torch/core/engine.py", "grid level", 1,
        "this class block's padded pair block, uploaded"),
    "grid.supports_gather": SyncSite(
        "repro_torch/core/engine.py", "grid level", 1,
        "every class block's supports (all-gathered over class), read back"),
    "mesh.survivor_upload": SyncSite(
        "repro_torch/core/engine.py", "sharded or grid level with survivors", 1,
        "the gathered survivor rows' order, uploaded"),
}

_SYNC_TEXT = "synchronizing CUDA operation"
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files() -> List[str]:
    from .astlint import iter_python_files
    return iter_python_files(os.path.dirname(_PORT), [os.path.basename(_PORT)])


def declared_syncs() -> Dict[Tuple[str, int], str]:
    """``{(module path under src/, line): site}`` of every sync marker in
    the port's source."""
    from .astlint import sync_markers
    return {(m.path, m.line): m.site
            for m in sync_markers(_port_files(), os.path.dirname(_PORT))}


def _expected(units: Dict[str, int]) -> Dict[str, int]:
    """The declared syncs of ``units`` (unit -> how many), by site."""
    out: Dict[str, int] = {}
    for site, s in SYNC_BUDGET.items():
        n = units.get(s.unit, 0) * s.count
        if n:
            out[site] = n
    return out


def budget_total(units: Dict[str, int]) -> int:
    """How many syncs :data:`SYNC_BUDGET` declares for ``units`` in all:
    what the card may synchronise on in that much work."""
    return sum(_expected(units).values())


def compile_findings() -> List[Finding]:
    """SH001's static part: no ``torch.compile`` (or ``torch._dynamo``)
    anywhere in the port's source, so nothing the mining path runs is ever
    recompiled."""
    import ast
    findings = []
    for path in _port_files():
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        rel = os.path.relpath(path, os.path.dirname(_PORT)).replace(os.sep, "/")
        for node in ast.walk(tree):
            name = None
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch" and node.attr in ("compile", "_dynamo"):
                name = f"torch.{node.attr}"
            elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                    "torch._dynamo"):
                name = node.module
            if name:
                findings.append(Finding(
                    rule="SH001", path=rel, line=node.lineno,
                    message=f"{name} in the port: a compiled graph recompiles "
                            f"on a new shape, which the audit cannot see"))
    return findings


# ---------------------------------------------------------------------------
# what the card synchronised on: the profiler's CUDA runtime calls
# ---------------------------------------------------------------------------

# the runtime calls that hold the host until the card has caught up
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")
# the record_function marks that cut the trace: the audited region, each
# level (an ``Engine.expand``) and each stream slide
REGION, LEVEL, SLIDE = "staticcheck::region", "staticcheck::level", "staticcheck::slide"


@dataclasses.dataclass(frozen=True)
class CardEvent:
    """One entry of a profiler trace that the card's count reads, on the
    host clock (microseconds): a ``record_function`` range (``kind``
    ``"range"``, ``name`` its mark), a synchronising runtime call
    (``"sync"``) or a runtime copy whose device copy runs device to host
    (``"d2h"``)."""

    kind: str
    name: str
    start: float
    end: float


def card_events(prof) -> List[CardEvent]:
    """The marks, synchronising calls and device-to-host copy calls of a
    ``torch.profiler.profile`` run with the CUDA activity, in start order.
    A runtime copy call is matched to its device copy (``Memcpy DtoH``) by
    the correlation id the profiler gives both."""
    evs = list(prof.events())
    d2h = {e.id for e in evs
           if str(e.device_type).endswith("CUDA") and "DtoH" in e.name}
    out = []
    for e in evs:
        if not str(e.device_type).endswith("CPU"):
            continue
        if e.name in (REGION, LEVEL, SLIDE):
            kind = "range"
        elif e.name in _SYNC_CALLS:
            kind = "sync"
        elif e.name.startswith("cudaMemcpy") and e.id in d2h:
            kind = "d2h"
        else:
            continue
        out.append(CardEvent(kind, e.name, float(e.time_range.start),
                             float(e.time_range.end)))
    return sorted(out, key=lambda c: (c.start, c.kind != "range"))


def _ranges(events: Sequence[CardEvent], name: str, lo: float = float("-inf"),
            hi: float = float("inf")) -> List[Tuple[float, float]]:
    return [(e.start, e.end) for e in events
            if e.kind == "range" and e.name == name and lo <= e.start < hi]


def _count_card(events: Sequence[CardEvent], lo: float, hi: float,
                skip: Sequence[Tuple[float, float]] = ()) -> Dict[str, int]:
    """The syncs that start in ``[lo, hi)`` outside the ``skip`` ranges:
    ``syncs`` (the runtime calls), ``d2h`` (device-to-host copies no such
    call follows next) and their ``total``."""
    sel = [e for e in events if e.kind != "range" and lo <= e.start < hi
           and not any(a <= e.start < b for a, b in skip)]
    syncs = sum(e.kind == "sync" for e in sel)
    lone = sum(e.kind == "d2h" and not (i + 1 < len(sel) and sel[i + 1].kind == "sync")
               for i, e in enumerate(sel))
    return {"syncs": syncs, "d2h": lone, "total": syncs + lone}


def cut_card_syncs(events: Sequence[CardEvent]) -> dict:
    """A region's card syncs cut at its level marks: ``{"levels": [per
    level], "outside": the rest of the region}``, each :func:`_count_card`'s
    dict."""
    (lo, hi), = _ranges(events, REGION)
    levels = _ranges(events, LEVEL, lo, hi)
    return {"levels": [_count_card(events, a, b) for a, b in levels],
            "outside": _count_card(events, lo, hi, levels)}


def cut_card_slides(events: Sequence[CardEvent]) -> List[dict]:
    """A stream region's card syncs cut at its slide marks, each slide's at
    its level marks: one :func:`cut_card_syncs` dict per slide."""
    out = []
    for lo, hi in _ranges(events, SLIDE):
        levels = _ranges(events, LEVEL, lo, hi)
        out.append({"levels": [_count_card(events, a, b) for a, b in levels],
                    "outside": _count_card(events, lo, hi, levels)})
    return out


def card_sync_findings(target: str, what: str, units: Dict[str, int],
                       counted: Dict[str, int]) -> List[Finding]:
    """SH002 on the card's count: ``counted`` (a :func:`_count_card` dict)
    may not exceed :data:`SYNC_BUDGET`'s total for ``units``."""
    declared = budget_total(units)
    if counted["total"] <= declared:
        return []
    return [Finding(rule="SH002", path=target, line=0,
                    message=f"{what}: the card synchronised {counted['total']} "
                            f"times (profiler: {counted['syncs']} synchronising "
                            f"calls, {counted['d2h']} device-to-host copies "
                            f"without one) > the {declared} declared for {units} "
                            f"(shapes.SYNC_BUDGET)")]


# ---------------------------------------------------------------------------
# the audited region
# ---------------------------------------------------------------------------

class _Region:
    """Counts what a block of work does on the card: the synchronising
    calls (torch's sync-debug warnings, each with its source line), what
    the card synchronised on (``card``: the profiler's :class:`CardEvent`
    list, the region marked :data:`REGION`), the caching allocator's new
    segments and retries, and any build or reload of the kernel library.
    ``mark()`` is an index into the calls, to cut them into levels and
    slides.  On the host it counts nothing."""

    def __init__(self, device):
        import torch
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.calls: list = []
        self.card: List[CardEvent] = []
        self.segments = self.retries = 0
        self.rebuilt = False

    def mark(self) -> int:
        return len(self.calls)

    @contextlib.contextmanager
    def active(self):
        if not self.on_card:
            yield self
            return
        import torch
        from ..kernels import _build
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize(self.device)
        lib, info = _build._LIB, _build.build_info()
        before = torch.cuda.memory_stats(self.device)
        # the profiler outside the warn mode: its own stop synchronises
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                self.calls = seen
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with record_function(REGION):
                        yield self
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        self.card = card_events(prof)
        torch.cuda.synchronize(self.device)
        after = torch.cuda.memory_stats(self.device)
        self.segments = (after.get("segment.all.allocated", 0)
                         - before.get("segment.all.allocated", 0))
        self.retries = after.get("num_alloc_retries", 0) - before.get("num_alloc_retries", 0)
        self.rebuilt = _build._LIB is not lib or _build.build_info() != info
        # every warning keeps its place (the marks index them); only the
        # syncs are counted
        self.calls = [(w.filename, w.lineno, _SYNC_TEXT in str(w.message))
                      for w in seen]
        for w in seen:
            if _SYNC_TEXT not in str(w.message):
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

    def sites(self, indices: Iterable[int],
              declared: Dict[Tuple[str, int], str]) -> Dict[str, int]:
        """The synchronising calls among ``indices`` by site; a call on a
        line no marker declares is keyed by its file:line."""
        out: Dict[str, int] = collections.Counter()
        for i in indices:
            filename, lineno, is_sync = self.calls[i]
            if not is_sync:
                continue
            norm = filename.replace(os.sep, "/")
            cut = norm.rfind("repro_torch/")
            rel = norm[cut:] if cut >= 0 else norm
            out[declared.get((rel, lineno), f"{rel}:{lineno}")] += 1
        return dict(out)

    def sh001(self, target: str) -> List[Finding]:
        findings = []
        if self.rebuilt:
            findings.append(Finding(
                rule="SH001", path=target, line=0,
                message="the audited region built or reloaded the kernel library"))
        if self.segments or self.retries:
            findings.append(Finding(
                rule="SH001", path=target, line=0,
                message=f"the audited region allocated {self.segments} new "
                        f"allocator segment(s) ({self.retries} retries) after "
                        f"warm-up: a buffer escaped the bucket ladder"))
        return findings


def _sync_finding(target: str, what: str, declared: Dict[str, int],
                  counted: Dict[str, int]) -> List[Finding]:
    if counted == declared:
        return []
    return [Finding(rule="SH002", path=target, line=0,
                    message=f"{what}: host syncs counted {counted or '{}'} != "
                            f"declared {declared or '{}'} (shapes.SYNC_BUDGET)")]


def _mark_levels(engine, region: _Region, spans: List[Tuple[int, int]]) -> None:
    """Mark every ``engine.expand`` call in ``region``: ``spans`` receives
    one ``(lo, hi)`` pair of call indices per level, and the profiler a
    :data:`LEVEL` range (an instance attribute over the method, dropped by
    :func:`_unmark`)."""
    real = engine.expand

    from torch.profiler import record_function

    def expand(*args, **kwargs):
        lo = region.mark()
        try:
            with record_function(LEVEL):
                return real(*args, **kwargs)
        finally:
            spans.append((lo, region.mark()))

    engine.expand = expand


def _unmark(engine) -> None:
    engine.__dict__.pop("expand", None)


@contextlib.contextmanager
def _mine_levels(region: _Region):
    """The engine the next ``mine()`` builds, its levels marked: a patch of
    this process's ``core.engine.resolve_engine`` for the duration.  Yields
    ``(engines, spans)``."""
    from ..core import engine as eng
    made: list = []
    spans: List[Tuple[int, int]] = []
    real = eng.resolve_engine

    def resolve(*args, **kwargs):
        made.append(real(*args, **kwargs))
        _mark_levels(made[-1], region, spans)
        return made[-1]

    eng.resolve_engine = resolve
    try:
        yield made, spans
    finally:
        eng.resolve_engine = real
        for e in made:
            _unmark(e)


def _outside(lo: int, hi: int, spans: Sequence[Tuple[int, int]]) -> List[int]:
    """The call indices in ``[lo, hi)`` that no level's span holds."""
    inside = {i for a, z in spans for i in range(a, z)}
    return [i for i in range(lo, hi) if i not in inside]


# ---------------------------------------------------------------------------
# synthetic deterministic stream (the reference's)
# ---------------------------------------------------------------------------

def _batches(rng: np.random.Generator, n: int, *, n_items: int,
             block_txns: int) -> List[List[List[int]]]:
    """``n`` micro-batches with a planted frequent 4-itemset so mining goes
    deep (levels >= 4) while the bulk of each transaction stays random."""
    out = []
    for _ in range(n):
        batch = []
        for _ in range(block_txns):
            t = set(rng.choice(n_items, size=int(rng.integers(2, 8)),
                               replace=False).tolist())
            if rng.random() < 0.6:
                t |= {0, 1, 2, 3}
            batch.append(sorted(t))
        out.append(batch)
    return out


def _ladder_findings(level_padding: Sequence[Tuple[int, int]], floor: int,
                     n_pair_devices: int, target: str) -> List[Finding]:
    """SH003 for every recorded padding that is not a per-device ladder rung."""
    from ..core.engine import bucket_size

    findings = []
    d = max(int(n_pair_devices), 1)
    for q, padded in level_padding:
        per_dev = padded // d if padded % d == 0 else padded
        if bucket_size(per_dev, floor) != per_dev:
            findings.append(Finding(
                rule="SH003", path=target, line=0,
                message=f"level padding {padded} for q={q} is off the "
                        f"bucket ladder (per-device {per_dev}, floor {floor})"))
    return findings


def _checks(on_card: bool) -> dict:
    if on_card:
        return {"checks": ["SH001", "SH002", "SH003"], "not_checked": None}
    return {"checks": ["SH001 (static: no torch.compile)", "SH003"],
            "not_checked": "SH002 (the warn mode's and the profiler's counts) "
                           "and SH001's build and allocator checks read the "
                           "card: on the host there is no sync, segment or "
                           "kernel build to count"}


# ---------------------------------------------------------------------------
# audits
# ---------------------------------------------------------------------------

def audit_mine(backend: str = "fused", *, compact: bool = True, device=None,
               min_levels: int = 3, n_txn: int = 512, n_items: int = 48,
               seed: int = 1) -> Tuple[List[Finding], dict]:
    """The warm batch ``mine()`` run, level by level.

    The first run warms the allocator, the kernel library and the K2
    look-back state; the second, identical run is audited.  Each level
    (one ``Engine.expand``) must make exactly the syncs of one "level" (and,
    with ``compact=False``, one "level without compaction"); the rest of the
    run exactly those of one "co-occurrence count" (the level-1 frontier
    uploaded, K4's counts read back).  The planted itemset makes the lattice
    at least ``min_levels`` deep.  ``device``: ``None`` = CUDA."""
    from ..core.eclat import EclatConfig, mine
    from ..device import resolve_device

    dev = resolve_device(device)
    target = f"<runtime:mine/{backend}/compact={compact}>"
    rng = np.random.default_rng(seed)
    txns = _batches(rng, 1, n_items=n_items, block_txns=n_txn)[0]
    cfg = EclatConfig(min_sup=0.25, variant="v3", backend=backend,
                      compact=compact)
    mine(txns, n_items, cfg, device=dev)               # warm run
    region = _Region(dev)
    declared = declared_syncs()
    with _mine_levels(region) as (made, level_spans), region.active():
        res = mine(txns, n_items, cfg, device=dev)
    engine = made[-1]

    findings: List[Finding] = list(compile_findings())
    per_level = []
    level_units = {"level": 1, "level without compaction": 0 if compact else 1}
    card_out = None
    if region.on_card:
        want = _expected(level_units)
        card = cut_card_syncs(region.card)
        if len(card["levels"]) != len(level_spans):
            findings.append(Finding(
                rule="SH002", path=target, line=0,
                message=f"the profiler marked {len(card['levels'])} levels, the "
                        f"audit {len(level_spans)}: the card's count cannot be cut"))
        for i, (lo, hi) in enumerate(level_spans):
            got = region.sites(range(lo, hi), declared)
            on_card = card["levels"][i] if i < len(card["levels"]) else None
            per_level.append({"level": i + 2, "declared": want, "counted": got,
                              "card": on_card})
            findings += _sync_finding(target, f"level {i + 2}", want, got)
            if on_card is not None:
                findings += card_sync_findings(target, f"level {i + 2}",
                                               level_units, on_card)
        outside_units = {"co-occurrence count": 1}
        want_out = _expected(outside_units)
        got_out = region.sites(_outside(0, len(region.calls), level_spans),
                               declared)
        findings += _sync_finding(target, "outside the levels", want_out, got_out)
        card_out = card["outside"]
        findings += card_sync_findings(target, "outside the levels", outside_units,
                                       card_out)
        findings += region.sh001(target)
    else:
        want_out = got_out = None
    findings.extend(_ladder_findings(engine.level_padding, engine.buffers.floor,
                                     getattr(engine, "n_devices", 1), target))
    levels = len(res.counts)
    if levels < min_levels:
        findings.append(Finding(
            rule="SH001", path=target, line=0,
            message=f"mine audit only reached {levels} levels "
                    f"(< {min_levels}) — audit lost its deep-expand "
                    f"coverage; re-tune the planted itemset"))
    summary = {
        "target": target, "device": str(dev), "levels": levels,
        "itemsets": res.total, "counts": list(res.counts),
        "level_padding": [list(p) for p in engine.level_padding],
        "syncs": {"per_level": per_level,
                  "outside_levels": {"declared": want_out, "counted": got_out,
                                     "card": card_out}},
        "allocator": ({"segments_added": region.segments,
                       "alloc_retries": region.retries} if region.on_card else None),
        "findings": len(findings), **_checks(region.on_card),
    }
    return findings, summary


def audit_streaming(backend: str = "fused", shard: str = "pairs", mesh=None,
                    *, compact: bool = True, device=None, slides: int = 5,
                    warmup: int = 6, n_items: int = 48, n_blocks: int = 4,
                    block_txns: int = 128, min_sup: int = 8,
                    seed: int = 0) -> Tuple[List[Finding], dict]:
    """``slides`` steady-state window slides, each audited.

    Fills the window and runs ``warmup`` live slides over a periodic stream
    (its window cycles with period ``n_blocks + 1``, so one warm cycle visits
    every window state the audited slides replay), then audits ``slides``
    more.  A slide must make exactly the syncs of one "push" and of one
    "co-occurrence count" per counted block (two once the window is full:
    the admitted and the evicted block) outside its levels, and of one
    "level" (plus one "level without compaction" with ``compact=False``) in
    each of its levels."""
    from ..device import resolve_device
    from ..streaming.miner import StreamConfig, StreamingMiner

    dev = resolve_device(device)
    target = f"<runtime:streaming/{backend}/{shard}/compact={compact}>"
    rng = np.random.default_rng(seed)
    period = n_blocks + 1
    distinct = _batches(rng, period, n_items=n_items, block_txns=block_txns)
    batches = [distinct[i % period] for i in range(n_blocks + warmup + slides)]
    cfg = StreamConfig(min_sup=min_sup, n_blocks=n_blocks,
                       block_txns=block_txns, backend=backend, shard=shard,
                       compact=compact)
    miner = StreamingMiner(n_items, cfg, mesh=mesh, device=dev)
    for b in batches[: n_blocks + warmup]:
        miner.advance(b)

    from torch.profiler import record_function
    declared = declared_syncs()
    region = _Region(dev)
    per_slide, counts, bounds = [], [], []
    spans: List[Tuple[int, int]] = []
    _mark_levels(miner.engine, region, spans)
    try:
        with region.active():
            for b in batches[n_blocks + warmup:]:
                evicts = miner.ring.full
                lo, first = region.mark(), len(spans)
                with record_function(SLIDE):
                    res = miner.advance(b)
                bounds.append((lo, region.mark(), first, len(spans), evicts))
                counts.append(list(res.counts))
    finally:
        _unmark(miner.engine)
    findings: List[Finding] = []
    if region.on_card:
        level_units = {"level": 1, "level without compaction": 0 if compact else 1}
        want_level = _expected(level_units)
        card = cut_card_slides(region.card)
        if [len(c["levels"]) for c in card] != [last - first for _, _, first, last, _
                                                 in bounds]:
            findings.append(Finding(
                rule="SH002", path=target, line=0,
                message="the profiler's slide and level marks differ from the "
                        "audit's: the card's count cannot be cut"))
            card = [None] * len(bounds)
        for i, (lo, hi, first, last, evicts) in enumerate(bounds):
            lspans = spans[first:last]
            levels = [region.sites(range(a, z), declared) for a, z in lspans]
            got_out = region.sites(_outside(lo, hi, lspans), declared)
            out_units = {"push": 1, "co-occurrence count": 2 if evicts else 1}
            want_out = _expected(out_units)
            per_slide.append({"slide": i, "levels": len(lspans),
                              "declared": {"per_level": want_level,
                                           "outside_levels": want_out},
                              "counted": {"per_level": levels,
                                          "outside_levels": got_out},
                              "card": card[i]})
            findings += _sync_finding(target, f"audited slide {i} outside its "
                                      f"levels", want_out, got_out)
            for k, got in enumerate(levels):
                findings += _sync_finding(target, f"audited slide {i} level "
                                          f"{k + 2}", want_level, got)
            if card[i] is None:
                continue
            findings += card_sync_findings(target, f"audited slide {i} outside its "
                                           f"levels", out_units, card[i]["outside"])
            for k, got in enumerate(card[i]["levels"]):
                findings += card_sync_findings(target, f"audited slide {i} level "
                                               f"{k + 2}", level_units, got)
        findings += region.sh001(target)
    findings.extend(_ladder_findings(
        miner.engine.level_padding, miner.engine.buffers.floor,
        getattr(miner.engine, "n_devices", 1), target))
    summary = {
        "target": target, "device": str(dev), "warmup_slides": warmup,
        "audited_slides": len(bounds),
        "itemsets_last_slide": sum(counts[-1]) if counts else 0,
        "counts": counts,
        "level_padding": [list(p) for p in miner.engine.level_padding],
        "syncs": per_slide,
        "allocator": ({"segments_added": region.segments,
                       "alloc_retries": region.retries} if region.on_card else None),
        "findings": len(findings), **_checks(region.on_card),
    }
    return findings, summary


# ---------------------------------------------------------------------------
# must-fail fixture: the audit layer's own self-test
# ---------------------------------------------------------------------------

def check_shape_fixture(device=None) -> List[Finding]:
    """Run deliberately contract-breaking work; MUST return findings.

    Three planted violations, one per rule:

      SH001  after a warm-up allocation, growing allocations off any ladder,
             each larger than every free block the allocator holds: each
             needs a new allocator segment;
      SH002  an undeclared ``.item()`` in the audited region;
      SH003  a recorded padding that sits between ladder rungs.

    On the host only SH003 can fire."""
    import torch
    from ..device import resolve_device

    dev = resolve_device(device)
    target = "<fixture:shapes>"
    findings: List[Finding] = []
    region = _Region(dev)
    base = 64                                     # MiB
    if region.on_card:
        # past every free block the cache already holds, whatever ran before
        torch.cuda.empty_cache()
        stats = torch.cuda.memory_stats(dev)
        base += (stats.get("reserved_bytes.all.current", 0)
                 - stats.get("allocated_bytes.all.current", 0)) >> 20
    warm = torch.empty(base << 20, dtype=torch.uint8, device=dev)
    del warm
    with region.active():
        grown = [torch.empty((base + n) << 20, dtype=torch.uint8, device=dev)
                 for n in (2, 4, 6)]              # rung-less growth
        total = torch.ones(4, device=dev).sum().item()   # an undeclared sync
    del grown
    if region.on_card:
        findings += region.sh001(target)
        got = region.sites(range(len(region.calls)), declared_syncs())
        findings += _sync_finding(target, f"fixture region (sum {total:g})", {}, got)
    findings.extend(_ladder_findings(
        [(5, 130)], floor=128, n_pair_devices=1, target=target))
    return findings


def check_card_sync_fixture(device=None) -> Tuple[List[Finding], dict]:
    """Make one sync the warn mode misses inside a level; MUST return a
    finding, and only through the profiler's count.

    Inside a :data:`LEVEL` range of an audited region it records a CUDA
    event and waits for it (``torch.cuda.Event.synchronize``, which calls
    ``cudaEventSynchronize`` without torch's sync-debug hook).  A level of
    this fixture declares no sync.  Returns the card's findings and what
    each count saw: ``warn_mode`` (the sync-debug warnings by site, which
    must stay empty) and ``card`` (the profiler's count in the level).  On
    the host nothing is counted there: no finding, and the summary says
    so."""
    import torch
    from torch.profiler import record_function
    from ..device import resolve_device

    dev = resolve_device(device)
    target = "<fixture:card_sync>"
    region = _Region(dev)
    if not region.on_card:
        return [], {"warn_mode": None, "card": None,
                    "not_checked": "not counted there: the host has no card to "
                                   "synchronise with"}
    x = torch.ones(1 << 20, device=dev)
    with region.active():
        with record_function(LEVEL):
            y = x * 2
            done = torch.cuda.Event()
            done.record()
            done.synchronize()              # cudaEventSynchronize, unwarned
    del y
    warned = region.sites(range(len(region.calls)), declared_syncs())
    (level,) = cut_card_syncs(region.card)["levels"]
    findings = card_sync_findings(target, "fixture level", {}, level)
    return findings, {"warn_mode": warned, "card": level, "not_checked": None}


SHAPE_FIXTURES = ("shapes", "card_sync")

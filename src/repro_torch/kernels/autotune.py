"""Measured tile selection for the port's kernels.

The counterpart of the reference's ``kernels/autotune.py``, with the
port's tiles in place of the Pallas ``block_w``:

* **K2** (``compact_pairs_kernel``): the lanes per pair, 8, 16 or 32
  (tiles of 128, 64 or 8 consecutive pairs).  The kernel's rule (8 for
  rows of at most 64 elements, else 32) is the default.  ``block_w`` keeps
  the reference's name and role, "the word tile of the fused kernel; None
  = table": here it is the words one pair's lanes cover per step of K2's
  loop (lanes x words per load x elements in flight), so a row has one
  ``block_w`` per instantiation of K2 (:func:`kernel_block_ws`).
* **K4** (``trimatrix_wgmma_kernel``): the number of ranges its word axis
  is cut into (``kernels.trimatrix.plan_for``); ``split_plan``'s model is
  the default.
* **K1** (``fused_pairs_kernel``, kernel ``"pairs"``) and **K3**
  (``partial_pairs_kernel``, ``"partial"``): the window plan ``(tile,
  rows, chunk)``, pairs a block, rows of its window, words of each row
  staged at once; the kernels' rule (``window_plan``) is the default.
  ``block_w`` names the plan's ``chunk`` here (:func:`plan_for_block_w`):
  the words of a row staged at once, the reference's word tile.

1.  **Shape classes.**  A call is keyed by its kernel, the power-of-two
    rungs of its pair count (or rows) and word width, the intersect mode,
    and the card's name (``torch.cuda.get_device_name``), or ``"cpu"``.  An
    entry from another card is a miss.  K1's and K3's classes take the
    exact word width in place of its rung: a plan's chunk is checked
    against the row's width (a chunk of a whole row at one width is a
    staged chunk at a wider one), and a mine's frontier keeps one width.
2.  **Cost-model seeding.**  Candidates are ordered by
    ``analysis.roofline``'s models, so a truncated sweep keeps the
    predicted winner; on a miss :func:`lookup` returns the model's pick.
3.  **Measurement, then cache.**  :func:`tune_shape` times every candidate
    on synthetic data of the class's shape (CUDA events,
    ``launch.kernel_timing.device_ms``) and stores the winner with its time
    in a JSON table at ``REPRO_TORCH_AUTOTUNE_CACHE`` or
    ``~/.cache/repro-eclat-torch/autotune.json`` (never the reference's
    path).  A corrupt file is a miss.
4.  **Lookup at launch.**  ``fused_intersect_compact_pairs(lanes=None)``,
    ``fused_intersect_pairs(plan=None)``,
    ``fused_intersect_partial_pairs(plan=None)`` and ``ops.cooccurrence``
    read the table (:func:`table_config`): a host dict hit, no
    synchronisation; with no entry the kernel keeps its rule.

On the CPU the plain versions have no tile, so every candidate list
collapses to the one entry of the rule, and :func:`tune_shape` times that
plain version with the host clock (``clock: "host"`` in its entry).

The tuner's launches are counted apart, in :data:`launches`: it calls the
kernels' uncounted launchers, so a run's ``kernels.launch_counts()`` holds
only the launches of its own path.  The tuner makes no collective; ranks
of a mesh tune their own slices and may pick differently, which changes no
result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.roofline import cooccurrence_cost, intersect_cost
from .fused_intersect.fused_intersect import (COMPACT_LANES, COMPACT_UNROLL,
                                              MODE_TIDSET, RULE_PLAN,
                                              WINDOW_ROWS_MAX, WINDOW_SMEM_MAX,
                                              WINDOW_TILE_MIN, WindowPlan,
                                              elem_words, rule_at_tile,
                                              rule_lanes, skewed_chunk,
                                              window_plan, window_skew)
from .trimatrix.trimatrix import STAGE_WORDS, plan_for, split_plan

__all__ = ["KernelConfig", "KERNELS", "device_kind", "shape_class",
           "block_w_of", "kernel_block_ws", "lanes_for_block_w",
           "block_w_candidates", "seeded_candidates", "split_candidates",
           "seeded_splits", "window_candidates", "window_block_ws",
           "window_chunk_candidates", "plan_for_block_w", "WINDOW_KERNELS",
           "AutotuneTable", "table_path", "load_table", "reset",
           "table_config", "lookup", "tune_shape", "CACHE_ENV"]

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_DEFAULT_CACHE = os.path.join("~", ".cache", "repro-eclat-torch", "autotune.json")
KERNELS = ("compact", "trimatrix", "pairs", "partial")
WINDOW_KERNELS = ("pairs", "partial")   # K1 and K3: their plans
WINDOW_TILES = tuple(WINDOW_TILE_MIN << k for k in range(6))   # 8 .. 256 pairs
# pitches of the power-of-two staged chunks offered to K1 and K3, in words
PITCH_BUDGETS = tuple(2 ** k for k in range(6, 13))            # 64 .. 4,096
MAX_WINDOW_CANDIDATES = 8

# launches the tuner made (its own count, kept out of kernels.launch_counts)
launches = 0

_LOCK = threading.Lock()        # the table: loaded once, written by the tuner
_TABLE: Optional["AutotuneTable"] = None
_KINDS: Dict[int, str] = {}     # device index -> card name


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One tuned configuration: ``lanes`` for K2 (0 = its rule), ``split``
    for K4 (word ranges; 0 = ``split_plan``'s), ``plan`` for K1 and K3
    (``(tile, rows, chunk)``; all zeros = their rule).  A table written
    before K1 and K3 had plans has no ``plan`` key, and its entries mean
    what they meant."""

    lanes: int = 0
    split: int = 0
    plan: Tuple[int, int, int] = RULE_PLAN

    def __post_init__(self):
        object.__setattr__(self, "plan", tuple(int(x) for x in self.plan))

    def to_dict(self) -> dict:
        d = {"lanes": int(self.lanes), "split": int(self.split)}
        if tuple(self.plan) != RULE_PLAN:
            d["plan"] = [int(x) for x in self.plan]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        plan = d.get("plan") or RULE_PLAN
        return cls(lanes=int(d.get("lanes", 0)), split=int(d.get("split", 0)),
                   plan=tuple(int(x) for x in plan)[:3])


def device_kind(device) -> str:
    """``"cpu"``, or the name of the card ``device`` is on."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _KINDS:
        _KINDS[idx] = torch.cuda.get_device_name(idx)
    return _KINDS[idx]


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < max(int(n), 1):
        b <<= 1
    return b


def shape_class(kernel: str, q: int, w: int, mode: int = MODE_TIDSET,
                kind: str = "cpu") -> str:
    """The table key of a call: the kernel (``compact``, ``trimatrix``,
    ``pairs`` or ``partial``), the power-of-two rungs of its pairs (rows for
    K4) and words (for K1's and K3's plans the words themselves), the mode,
    and the card's name (or ``"cpu"``)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
    words = max(int(w), 0) if kernel in WINDOW_KERNELS else _pow2_bucket(w)
    return f"{kernel}_q{_pow2_bucket(q)}_w{words}_m{int(mode)}_{kind}"


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

def block_w_of(w: int, lanes: int) -> int:
    """K2's word tile at ``lanes`` lanes per pair for ``w``-word rows: the
    words one pair's lanes cover per step of its loop."""
    return int(lanes) * elem_words(w) * COMPACT_UNROLL[int(lanes)]


def kernel_block_ws(w: int) -> List[int]:
    """The word tiles K2 has for a ``w``-word row, one per instantiation
    (8, 16 and 32 lanes): [128, 256, 1024] where ``w`` is a multiple of 4,
    else [32, 64, 256]."""
    return [block_w_of(w, g) for g in COMPACT_LANES]


def lanes_for_block_w(w: int, block_w: int) -> int:
    """The lanes per pair of K2's word tile ``block_w`` for ``w``-word
    rows; any other value raises ``ValueError`` naming the candidates."""
    for g in COMPACT_LANES:
        if block_w_of(w, g) == int(block_w):
            return g
    raise ValueError(f"block_w={block_w!r} is not a word tile of the fused "
                     f"kernel for {w}-word rows; candidates: "
                     f"{kernel_block_ws(w)}")


def block_w_candidates(w: int, kind: str = "cpu") -> List[int]:
    """K2's word tiles for ``w``-word rows on ``kind``.  On the CPU the
    plain version has no tile, so the list is the rule's one entry."""
    if kind == "cpu":
        return [block_w_of(w, rule_lanes(w))]
    return kernel_block_ws(w)


def seeded_candidates(q: int, w: int, kind: str = "cpu") -> List[int]:
    """:func:`block_w_candidates` ordered by ``intersect_cost`` (best
    predicted first)."""
    def cost(bw):
        c = intersect_cost(q, w, lanes_for_block_w(w, bw))
        return (c.bound_s, c.model)
    return sorted(block_w_candidates(w, kind), key=cost)


def split_candidates(n: int, w: int, kind: str = "cpu") -> List[int]:
    """K4's word-range counts for an (n, w) product: the distinct plans of
    1, 2, 4, 8, ... ranges up to one a stage, and ``split_plan``'s pick.
    On the CPU the plain version has no split: the pick alone."""
    pick = split_plan(n, w)[0]
    if kind == "cpu":
        return [pick]
    stages = max(1, -(-w // STAGE_WORDS))
    splits = {pick}
    s = 1
    while s <= min(stages, 65535):
        splits.add(plan_for(w, s)[0])
        s *= 2
    return sorted(splits)


def seeded_splits(n: int, w: int, kind: str = "cpu") -> List[int]:
    """:func:`split_candidates` ordered by ``cooccurrence_cost``, ties to
    fewer ranges (``split_plan``'s pick first)."""
    def cost(s):
        c = cooccurrence_cost(n, w, plan_for(w, s))
        return (c.model, s)
    return sorted(split_candidates(n, w, kind), key=cost)


def _window_at(tile: int, chunk: int, w: int) -> Optional[WindowPlan]:
    """K1/K3's plan at ``tile`` pairs a block staging ``chunk`` words of a
    row at once (whole rows for ``chunk >= w``): a window of twice the
    tile's pairs in rows (at most 256), fewer where the stages would pass
    the shared memory a block may take; None where not one row fits.
    Checked by ``window_plan``."""
    whole = chunk >= w
    fit = ((WINDOW_SMEM_MAX - 16) // (4 * max(w, 1)) if whole
           else WINDOW_SMEM_MAX // (8 * (chunk + 4)))
    rows = min(2 * tile, WINDOW_ROWS_MAX, fit)
    return window_plan(0, w, (tile, rows, chunk)) if rows >= 1 else None


def window_candidates(q: int, w: int, kind: str = "cpu") -> List[WindowPlan]:
    """K1's and K3's plans for ``q`` pairs of ``w``-word rows on ``kind``,
    ordered by ``intersect_cost`` (best predicted first, ties to the
    earlier): the rule's plan, always; the rule's plan at its tile halved
    and doubled within 8-256 pairs; at the rule's tile, the skewed chunk
    under each power-of-two pitch (:data:`PITCH_BUDGETS`) that is shorter
    than the row, and whole rows where a full window of them fits; at most
    :data:`MAX_WINDOW_CANDIDATES` plans, the rule's among them.  On the CPU
    the plain versions have no tile: the rule's plan alone."""
    rule = window_plan(q, w)
    if kind == "cpu":
        return [rule]
    plans = [rule] + [window_plan(q, w, rule_at_tile(w, t))
                      for t in (rule.tile // 2, rule.tile * 2) if t in WINDOW_TILES]
    for pitch in PITCH_BUDGETS:
        chunk = skewed_chunk(pitch, rule.tile)
        if 0 < chunk < w:
            plans.append(_window_at(rule.tile, chunk, w))
    whole = _window_at(rule.tile, w, w)
    if whole is not None and whole.rows == min(2 * rule.tile, WINDOW_ROWS_MAX):
        plans.append(whole)
    seen, unique = set(), []
    for p in plans:
        if p is not None and p[:3] not in seen:
            seen.add(p[:3])
            unique.append(p)

    def cost(p):
        c = intersect_cost(q, w, plan=p)
        return (c.bound_s, c.model)
    ordered = sorted(unique, key=cost)
    if rule not in ordered[:MAX_WINDOW_CANDIDATES]:
        ordered = ordered[:MAX_WINDOW_CANDIDATES - 1] + [rule]
    return ordered[:MAX_WINDOW_CANDIDATES]


def window_block_ws() -> List[int]:
    """Every chunk K1 and K3 are offered, at any row width: the rule's
    chunks (one per window height) and the skewed chunks under each
    power-of-two pitch, at every tile.  The ``block_w`` values that name
    them (:func:`plan_for_block_w`); none is a power of two of 512 or
    more, the reference's Pallas tile widths."""
    names = set()
    for t in WINDOW_TILES:
        names.add(rule_at_tile(1 << 20, t)[2])   # rows too wide to stage whole
        names.update(skewed_chunk(p, t) for p in PITCH_BUDGETS)
    return sorted(names)


def window_chunk_candidates(q: int, w: int, kind: str = "cpu") -> List[int]:
    """The ``block_w`` of each plan of :func:`window_candidates`: its chunk,
    or for whole rows the least name of :func:`window_block_ws` that is at
    least ``w`` (none past the largest); distinct, ascending."""
    names = window_block_ws()
    out = set()
    for p in window_candidates(q, w, kind):
        if p.chunk < w:
            out.add(p.chunk)
        elif names[-1] >= w:
            out.add(min(n for n in names if n >= w))
    return sorted(out)


def plan_for_block_w(kernel: str, q: int, w: int, mode: int, block_w: int,
                     kind: str = "cpu") -> WindowPlan:
    """The plan of K1 (``kernel="pairs"``) or K3 (``"partial"``) that an
    explicit ``block_w`` names: ``chunk = block_w`` words of a row staged at
    once (whole rows for ``block_w >= w``).  The tile is the table's for
    this shape class, else the rule's; a staged chunk keeps a tile's bank
    skew only at the lanes per pair its pitch was skewed for, so where the
    table's or the rule's tile takes another skew, the nearest tile that
    takes this chunk's serves.  The window's rows are twice the tile's
    pairs, fewer where the stages would not fit.  A ``block_w`` the kernel
    cannot take raises ``ValueError`` naming this shape's chunks."""
    if kernel not in WINDOW_KERNELS:
        raise ValueError(f"{kernel!r} has no window plan; expected one of {WINDOW_KERNELS}")
    chunk = int(block_w)
    cfg = load_table().get(shape_class(kernel, q, w, mode, kind))
    base = cfg.plan[0] if cfg is not None and cfg.plan[0] else window_plan(q, w).tile
    tiles = ([base] if chunk >= w else
             [t for t in WINDOW_TILES if chunk > 0 and window_skew(t) == (chunk + 4) % 32])
    plan = None
    if tiles:
        tile = min(tiles, key=lambda t: (abs(t.bit_length() - base.bit_length()), t))
        plan = _window_at(tile, chunk, w)
    if plan is None:
        name = "fused_pairs_kernel (K1)" if kernel == "pairs" else "partial_pairs_kernel (K3)"
        raise ValueError(
            f"block_w={block_w!r} is not a chunk {name} can stage for {w}-word "
            f"rows; its chunks at this shape: "
            f"{[p.chunk for p in window_candidates(q, w, 'card') if p.chunk < w]}"
            f" (a block_w of at least {w} stages whole rows where they fit)")
    return plan


# ---------------------------------------------------------------------------
# the persistent table
# ---------------------------------------------------------------------------

class AutotuneTable:
    """Shape class -> :class:`KernelConfig`, persisted as JSON.  Entries
    carry their provenance (``source``) and, when measured, the winner's
    ``measured_ms`` and the clock that measured it."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, dict] = {}

    def get(self, key: str) -> Optional[KernelConfig]:
        e = self.entries.get(key)
        return KernelConfig.from_dict(e) if e is not None else None

    def put(self, key: str, config: KernelConfig, *,
            measured_ms: Optional[float] = None, clock: Optional[str] = None,
            source: str = "measured") -> None:
        entry = {**config.to_dict(), "source": source}
        if measured_ms is not None:
            entry["measured_ms"] = float(measured_ms)
            entry["clock"] = clock
        self.entries[key] = entry

    def load(self) -> "AutotuneTable":
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                shapes = data.get("shapes", {})
                if isinstance(shapes, dict):
                    self.entries.update(shapes)
            except (OSError, ValueError, AttributeError):
                pass  # a corrupt table is a miss, not a crash
        return self

    def save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "shapes": self.entries}, f, indent=2,
                      sort_keys=True)
        os.replace(tmp, self.path)


def table_path() -> str:
    return os.path.expanduser(os.environ.get(CACHE_ENV, _DEFAULT_CACHE))


def load_table(refresh: bool = False) -> AutotuneTable:
    """The process's table, loaded once from :func:`table_path` (under a
    lock: a serving writer thread launches kernels too)."""
    global _TABLE
    with _LOCK:
        if _TABLE is None or refresh:
            _TABLE = AutotuneTable(table_path()).load()
        return _TABLE


def reset() -> None:
    """Drop the process's table (tests; after the environment changes)."""
    global _TABLE
    with _LOCK:
        _TABLE = None


def table_config(kernel: str, q: int, w: int, mode: int,
                 device) -> Optional[KernelConfig]:
    """The table's entry for a call on ``device``, or None: the launch-time
    hook behind ``lanes=None`` and ``ops.cooccurrence``."""
    return load_table().get(shape_class(kernel, q, w, mode, device_kind(device)))


def lookup(kernel: str, q: int, w: int, mode: int = MODE_TIDSET,
           kind: str = "cpu") -> KernelConfig:
    """The tuned configuration of a shape class, or on a miss the cost
    model's pick (the first seeded candidate)."""
    cfg = load_table().get(shape_class(kernel, q, w, mode, kind))
    if cfg is not None:
        return cfg
    if kernel == "compact":
        return KernelConfig(lanes=lanes_for_block_w(w, seeded_candidates(q, w, kind)[0]))
    if kernel in WINDOW_KERNELS:
        return KernelConfig(plan=tuple(window_candidates(q, w, kind)[0][:3]))
    return KernelConfig(split=seeded_splits(q, w, kind)[0])


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _synthetic(q: int, w: int, n_rows: int, device, seed: int = 0):
    """Random words over ``n_rows`` rows and ``q`` random pairs, supports
    of full rows, min_sup at the expected count of an AND (about half the
    pairs survive in mode 0)."""
    from ..device import words_from_numpy
    rng = np.random.default_rng(seed)
    bitmaps = words_from_numpy(rng.integers(0, 2**32, (n_rows, w), dtype=np.uint32),
                               device)
    pairs = torch.from_numpy(rng.integers(0, n_rows, (2, q)).astype(np.int32)).to(device)
    sup_left = torch.full((q,), 32 * w, dtype=torch.int32, device=device)
    return bitmaps, pairs[0].contiguous(), pairs[1].contiguous(), sup_left, 8 * w


def _class_pairs(q: int, n_rows: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """``q`` pairs as the miner orders them: the rows cut into classes of
    1 to 25 consecutive rows, each class's upper-triangle pairs in order,
    the rows cut again from the top while more pairs are wanted (a
    one-row frontier pairs its row with itself)."""
    from ..core.equivalence import segment_pairs
    ls, rs, have = [], [], 0
    while have < q:
        sizes = []
        while sum(sizes) < n_rows:
            sizes.append(min(int(rng.integers(1, 26)), n_rows - sum(sizes)))
        sizes = np.asarray(sizes, np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        left, right = segment_pairs(starts, sizes)
        if left.shape[0] == 0:
            left = right = np.zeros(1, np.int64)
        ls.append(left)
        rs.append(right)
        have += left.shape[0]
    return (np.concatenate(ls)[:q].astype(np.int32),
            np.concatenate(rs)[:q].astype(np.int32))


def _host_ms(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def tune_shape(kernel: str, q: int, w: int, mode: int = MODE_TIDSET, *,
               device="cuda", rows: Optional[int] = None, reps: int = 20,
               max_candidates: Optional[int] = None, save: bool = True,
               store: bool = True) -> dict:
    """Time the seeded candidates of one shape class and store the winner.

    K2 runs ``q`` random pairs over ``rows`` random rows (default
    ``min(q, 4096)``: the frontier's height decides how much of it stays in
    L2), K4 ``q`` random rows; ``w`` words each.  K1 and K3 run ``q``
    class-ordered pairs (the windows they stage are the tile's choice) over
    ``rows`` random rows, with their (Q, W) store unless ``store=False``
    (K3 on a compacting word-sharded mine).  On the card each
    candidate's device time per call (CUDA events, calls back to back:
    ``launch.kernel_timing.device_ms``); the default tile (the rule's lanes,
    ``split_plan``'s split) is always among those timed, so the record
    compares the pick with it.  ``max_candidates`` keeps the model's first
    N.  On the CPU the one candidate is the plain version, timed with the
    host clock.  The tuner's launches go to :data:`launches`, not to the
    wrappers' counters.  Returns the record: per-candidate ms, the pick, the
    model's pick and the default's ms."""
    global launches
    device = torch.device(device)
    kind = device_kind(device)
    on_card = kind != "cpu"
    n_rows = max(min(int(q), 4096) if rows is None else int(rows), 1)
    if kernel == "compact":
        cands = seeded_candidates(q, w, kind)
        default = block_w_of(w, rule_lanes(w))
        bm, left, right, supl, msup = _synthetic(q, w, n_rows, device)
    elif kernel in WINDOW_KERNELS:
        cands = [tuple(p[:3]) for p in window_candidates(q, w, kind)]
        default = tuple(window_plan(q, w)[:3])
        bm, _, _, supl, msup = _synthetic(q, w, n_rows, device)
        lc, rc = _class_pairs(int(q), n_rows, np.random.default_rng(1))
        left = torch.from_numpy(lc).to(device)
        right = torch.from_numpy(rc).to(device)
    elif kernel == "trimatrix":
        cands = seeded_splits(q, w, kind)
        default = split_plan(q, w)[0]
        bm = _synthetic(1, w, max(int(q), 1), device)[0]
    else:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
    if max_candidates is not None:
        cands = cands[:max_candidates]
    timed = cands + ([default] if default not in cands else [])

    def call(c):
        if kernel in WINDOW_KERNELS:
            from .fused_intersect import fused_intersect_partial_ref, fused_intersect_ref
            from .fused_intersect.fused_intersect import launch_pairs, launch_partial
            if kernel == "pairs":
                if on_card:
                    return lambda: launch_pairs(bm, left, right, supl, msup, mode=mode,
                                                plan=c, store=store)
                return lambda: fused_intersect_ref(bm, left, right, supl, msup, mode=mode)
            if on_card:
                return lambda: launch_partial(bm, left, right, mode=mode, plan=c,
                                              store=store)
            return lambda: fused_intersect_partial_ref(bm, left, right, mode=mode,
                                                       store=store)
        if kernel == "compact":
            if on_card:
                from .fused_intersect.fused_intersect import launch_compact
                return lambda: launch_compact(bm, left, right, supl, msup, q,
                                              mode=mode,
                                              lanes=lanes_for_block_w(w, c))
            from .fused_intersect.ref import fused_intersect_compact_ref
            return lambda: fused_intersect_compact_ref(bm, left, right, supl,
                                                       msup, q, mode=mode)
        if on_card:
            from .trimatrix.trimatrix import launch_trimatrix
            return lambda: launch_trimatrix(bm, plan_for(w, c))
        from .trimatrix.ref import trimatrix_ref
        return lambda: trimatrix_ref(bm)

    timings: Dict[object, float] = {}
    for c in timed:
        fn = call(c)
        if on_card:
            from ..launch.kernel_timing import device_ms
            warmup = 3
            timings[c] = device_ms(fn, reps=reps, warmup=warmup)
            launches += reps + warmup
        else:
            timings[c] = _host_ms(fn, max(1, min(reps, 3)))
    best = min(timed, key=timings.get)
    if kernel == "compact":
        config = KernelConfig(lanes=lanes_for_block_w(w, best))
    elif kernel in WINDOW_KERNELS:
        config = KernelConfig(plan=best)
    else:
        config = KernelConfig(split=best)

    def label(c):
        return "/".join(str(x) for x in c) if kernel in WINDOW_KERNELS else str(c)

    def value(c):
        return list(c) if kernel in WINDOW_KERNELS else int(c)
    key = shape_class(kernel, q, w, mode, kind)
    table = load_table()
    with _LOCK:
        table.put(key, config, measured_ms=timings[best],
                  clock="cuda_events" if on_card else "host")
        if save:
            table.save()
    return {
        "kernel": kernel, "key": key, "q": int(q), "w": int(w),
        "rows": int(q if kernel == "trimatrix" else n_rows),
        "mode": int(mode), "kind": kind,
        "clock": "cuda_events" if on_card else "host",
        "candidates": {label(c): timings[c] for c in timed},
        "tuned": value(best), "config": config.to_dict(),
        "model_pick": value(cands[0]), "model_agrees": bool(best == cands[0]),
        "ms": timings[best], "default": value(default),
        "default_ms": timings[default],
    }

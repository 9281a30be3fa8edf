"""Meshes of ranks for the mining backends and for training, and the
launcher that starts the ranks.

Execution model: one process per rank (SPMD).  Every rank calls the same
``mine()`` on the same transactions; the host bookkeeping is deterministic
and runs identically on each, so every rank returns the same result, and
only the exchanges that the reference's ``shard_map`` performs implicitly
are collectives (:mod:`repro_torch.dist.collectives`).

The backend of the process group is the caller's choice:

  nccl   ranks on distinct cards (NCCL refuses two ranks on one card)
  gloo   ranks on the host, or several ranks sharing one card: payloads
         are exchanged through host copies

Nothing switches from one to the other.  Rank ``r`` computes on
``cuda:{r % device_count}``, or on the host when ``device="cpu"``.

    ranks = run_ranks(fn, 4, backend="gloo", device="cpu", args=(jobs,))

starts 4 ranks in ``spawn`` mode (so a child imports only what ``fn``'s
module needs), calls ``fn(device, *args)`` on each with the rank's torch
device, and returns their return values in rank order.  ``fn`` must be a
module-level function that pickles by reference.  The mesh functions below
need the process group that :func:`run_ranks` (or :func:`process_group`)
has set up.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["factor_grid", "parse_grid_arg", "make_data_mesh",
           "make_grid_mesh", "mesh_for_mining", "make_mesh", "make_mesh_named",
           "named_mesh_layout", "mesh_layout", "MeshLayout", "NAMED_MESHES",
           "process_group", "run_ranks", "DIST_BACKENDS"]

DIST_BACKENDS = ("nccl", "gloo")

# the reference's named meshes (launch/mesh.py make_mesh_named): shape and
# axis names, under every name the reference accepts
_TINY = ((2, 2), ("data", "model"))
_SINGLE = ((16, 16), ("data", "model"))
_MULTI = ((2, 16, 16), ("pod", "data", "model"))
_PIPELINE = ((2, 2, 8, 16), ("pipe", "pod", "data", "model"))
NAMED_MESHES = {"tiny": _TINY, "single": _SINGLE, "single_pod": _SINGLE,
                "16x16": _SINGLE, "multi": _MULTI, "multi_pod": _MULTI,
                "2x16x16": _MULTI, "pipeline": _PIPELINE}


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with run_ranks "
                           "(or enter process_group) before building a mesh")
    return dist.get_world_size()


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"


def make_data_mesh(axis: str = "data") -> DeviceMesh:
    """One axis, ``(axis,)``, over every rank of the process group."""
    n = _world()
    return DeviceMesh(_mesh_device_type(), torch.arange(n),
                      mesh_dim_names=(axis,))


def factor_grid(n: int) -> Tuple[int, int]:
    """Most-square ``(n_class, n_data)`` factorization of ``n`` ranks with
    ``n_class <= n_data`` (4 -> (2, 2), 8 -> (2, 4), 6 -> (2, 3), a prime p
    -> (1, p)).  Ties lean toward the data axis: frontier memory scales with
    ``n_data`` while pair work rebalances across levels anyway."""
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    best = (1, n)
    for c in range(1, math.isqrt(n) + 1):
        if n % c == 0:
            best = (c, n // c)
    return best


def make_grid_mesh(n_class: Optional[int] = None,
                   n_data: Optional[int] = None) -> DeviceMesh:
    """2D ``("class", "data")`` mesh for the grid engine: pairs split over
    ``class``, the frontier's word axis over ``data``; rank ``r`` sits at
    ``(r // n_data, r % n_data)``.  With neither dimension given the ranks
    are factorized most-square (:func:`factor_grid`); with one given, the
    other is the rank count divided by it.  Every rank must be on the mesh:
    a grid smaller than the process group is refused, since its other ranks
    would have nothing to run."""
    n = _world()
    if n_class is None and n_data is None:
        n_class, n_data = factor_grid(n)
    elif n_class is None:
        n_data = int(n_data)
        if n_data < 1 or n % n_data:
            raise ValueError(f"n_data={n_data} does not divide the {n} "
                             f"visible device(s)")
        n_class = n // n_data
    elif n_data is None:
        n_class = int(n_class)
        if n_class < 1 or n % n_class:
            raise ValueError(f"n_class={n_class} does not divide the {n} "
                             f"visible device(s)")
        n_data = n // n_class
    else:
        n_class, n_data = int(n_class), int(n_data)
    if n_class < 1 or n_data < 1 or n_class * n_data > n:
        raise ValueError(f"grid {n_class}x{n_data} needs "
                         f"{n_class * n_data} device(s); {n} visible")
    if n_class * n_data < n:
        raise ValueError(f"grid {n_class}x{n_data} uses {n_class * n_data} of "
                         f"the {n} ranks; start {n_class * n_data} ranks")
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(n).reshape(n_class, n_data),
                      mesh_dim_names=("class", "data"))


def parse_grid_arg(spec: Optional[str]) -> Tuple[Optional[int], Optional[int]]:
    """Parse a CLI ``--grid RxC`` string ("2x2", "4x1") into ``(n_class,
    n_data)``; ``None`` means auto-factorize (:func:`make_grid_mesh`)."""
    if spec is None:
        return None, None
    parts = spec.lower().replace("×", "x").split("x")
    if len(parts) != 2:
        raise ValueError(f"--grid expects RxC (e.g. 2x2), got {spec!r}")
    try:
        n_class, n_data = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"--grid expects integer RxC (e.g. 2x2), got {spec!r}")
    return n_class, n_data


def mesh_for_mining(backend: str, shard: str,
                    grid: Optional[str] = None) -> Optional[DeviceMesh]:
    """The mesh a mining request needs (the reference's routing): a 2D grid
    mesh for the grid mode (``grid`` is the raw ``--grid RxC`` string,
    auto-factorized when absent), a 1D ``("data",)`` mesh for the other
    mesh-mapped modes, ``None`` for the single-device backends."""
    if backend == "grid" or shard == "grid":
        return make_grid_mesh(*parse_grid_arg(grid))
    if grid is not None:
        # silently dropping --grid would run a different configuration than
        # the one the user asked to measure
        raise ValueError(
            f"--grid {grid} requires the grid mode (--shard grid or "
            f"--backend grid); got backend={backend!r}, shard={shard!r}")
    if backend in ("sharded", "tidsharded") or shard == "words":
        return make_data_mesh()
    return None


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, without ranks: what the placement
    rules read (the same two attributes as the reference's meshes)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def mesh_layout(shape: Sequence[int], axes: Sequence[str]) -> MeshLayout:
    """The layout of a mesh of ``shape`` over ``axes`` (no process group
    needed)."""
    shape, axes = tuple(int(n) for n in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or min(shape) < 1:
        raise ValueError(f"a mesh needs one size >= 1 for each of its distinct "
                         f"axes; got shape {shape} over {axes}")
    return MeshLayout(axes, dict(zip(axes, shape)))


def named_mesh_layout(name: str) -> MeshLayout:
    """The layout of a named mesh (no process group needed)."""
    if name not in NAMED_MESHES:
        raise ValueError(f"unknown mesh {name!r}; expected one of "
                         f"{sorted(NAMED_MESHES)}")
    return mesh_layout(*NAMED_MESHES[name])


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              what: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes`` on the ranks of the process group,
    as the reference's ``make_mesh(shape, axes)`` builds one: rank ``r`` at
    its row-major coordinate, the first axis major (``(2, 2, 1)`` over
    ``("pod", "data", "model")`` puts ranks 0, 1 in pod 0).  Raises
    ``ValueError`` when the process group does not hold exactly its ranks."""
    layout = mesh_layout(shape, axes)
    shape = tuple(layout.shape[a] for a in layout.axis_names)
    need, n = math.prod(shape), _world()
    if n != need:
        name = f"{what!r} {shape}" if what else f"{shape} over {layout.axis_names}"
        raise ValueError(f"mesh {name} needs {need} ranks; the process group "
                         f"has {n}")
    return DeviceMesh(_mesh_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=layout.axis_names)


def make_mesh_named(name: str) -> DeviceMesh:
    """The reference's named mesh over the ranks of the process group:
    ``tiny`` is (2, 2) ``("data", "model")`` (rank ``r`` at ``(r // 2, r %
    2)``), ``single`` (16, 16), ``multi`` (2, 16, 16) ``("pod", "data",
    "model")``, ``pipeline`` (2, 2, 8, 16).  Raises ``ValueError`` when the
    process group does not hold exactly the ranks the mesh needs."""
    layout = named_mesh_layout(name)
    return make_mesh([layout.shape[a] for a in layout.axis_names],
                     layout.axis_names, what=name)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_device(rank: int, device: str) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the host")
    return torch.device("cuda", rank % torch.cuda.device_count())


@contextlib.contextmanager
def process_group(backend: str, world: int, rank: int, init_method: str, *,
                  device: str = "cuda", timeout: float = 600.0):
    """Join a process group and yield this rank's torch device; the group
    is destroyed on exit.  ``world=1`` runs the real collective path in the
    calling process."""
    if backend not in DIST_BACKENDS:
        raise ValueError(f"unknown process-group backend {backend!r}; "
                         f"expected one of {DIST_BACKENDS}")
    dev = _rank_device(rank, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs ranks on the card; use gloo "
                         "for ranks on the host")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, backend, device, init_method, out_dir, timeout):
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        with open(os.path.join(out_dir, _ARGS), "rb") as f:
            fn, args = pickle.load(f)
        if device == "cpu":
            # several ranks share the host's cores
            torch.set_num_threads(1)
        with process_group(backend, world, rank, init_method, device=device,
                           timeout=timeout) as dev:
            result = ("ok", fn(dev, *args))
    except BaseException:  # report every failure to the parent
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    if result[0] != "ok":
        raise SystemExit(1)


# the file that hands the ranks ``fn`` and its arguments: a large pickle
# sent through a spawned child's pipe blocks ``Process.start`` until the
# child has imported torch, which would start the ranks one after another
_ARGS = "args.pkl"


def run_ranks(fn: Callable[..., Any], world: int, *, backend: str,
              device: str = "cuda", args: Sequence = (),
              timeout: float = 600.0) -> List[Any]:
    """Start ``world`` ranks (``torch.multiprocessing``, spawn mode, a
    ``file://`` rendezvous in a temporary directory), run ``fn(device,
    *args)`` on each and return the results in rank order.  Raises if a rank fails,
    or if the ranks have not all finished within ``timeout`` seconds (the
    rest are then killed); collectives time out after the same limit.

    On the card the kernel library is built here first, so the ranks load
    it instead of compiling it at once."""
    import torch.multiprocessing as mp

    world = int(world)
    if world < 1:
        raise ValueError(f"need at least one rank, got {world}")
    if device == "cuda":
        from ..kernels import _build
        _build.library()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        with open(os.path.join(tmp, _ARGS), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, device, init, tmp, timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        hung: List[int] = []
        try:
            # a failed rank leaves the others waiting in a collective: stop
            # them as soon as one exits with an error
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    hung = [r for r, p in enumerate(procs) if p.is_alive()]
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                if r not in hung:
                    errors.append(f"rank {r}: no result (exit code "
                                  f"{procs[r].exitcode})")
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r} failed:\n{value}")
            results.append(value)
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} did not finish within "
                               f"{timeout:.0f} s" + "".join(f"\n{e}" for e in errors))
        if errors:
            raise RuntimeError("\n".join(errors))
        return results

"""ctypes binding of the co-occurrence CUDA kernel (``csrc/trimatrix.cu``,
an int8 tensor-core product of the unpacked indicator), with its launch
counter ``trimatrix.launches`` and the split plan of its word axis."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build

__all__ = ["trimatrix", "launch_trimatrix", "split_plan", "split_cost",
           "plan_for", "TILE", "STAGE_WORDS", "SMS"]

TILE = 128          # output tile edge; csrc's kTile
STAGE_WORDS = 8     # words of a row per pipeline stage; csrc's kStageWords
SMS = 132           # streaming multiprocessors of an H100 SXM
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        lib.trimatrix_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.trimatrix_launch.restype = ctypes.c_int
        if (lib.trimatrix_tile(), lib.trimatrix_stage_words()) != (TILE, STAGE_WORDS):
            raise RuntimeError("trimatrix.TILE / STAGE_WORDS differ from the "
                               "CUDA source's")
        _BOUND = True
    return lib


def tile_count(n: int) -> int:
    """Output tiles on or above the diagonal: one block each per split."""
    t = -(-n // TILE)
    return t * (t + 1) // 2


def plan_for(w: int, splits: int) -> tuple:
    """``(splits, split_words)`` of the word axis of width ``w`` cut into at
    most ``splits`` ranges of whole stages: ranges of ``ceil(stages /
    splits)`` stages, as many as hold words (none is empty)."""
    stages = max(1, -(-w // STAGE_WORDS))
    per = -(-stages // max(1, min(int(splits), stages, 65535)))
    return -(-stages // per), per * STAGE_WORDS


def split_cost(n: int, plan: tuple) -> int:
    """The modelled time of an (n, w) co-occurrence under ``plan =
    (splits, split_words)``: waves of blocks (one block per SM) x (stages
    per block + 2 for a block's start and its store)."""
    splits, split_words = int(plan[0]), int(plan[1])
    return -(-tile_count(n) * splits // SMS) * (split_words // STAGE_WORDS + 2)


@functools.lru_cache(maxsize=None)
def split_plan(n: int, w: int) -> tuple:
    """``(splits, split_words)``: the word axis of an (n, w) co-occurrence
    cut into ``splits`` ranges of ``split_words`` words (a multiple of the
    stage; the last range may be shorter, none is empty), one block per
    (tile, range).

    It minimises the modelled time, :func:`split_cost`, so a small N
    splits the words until the few tiles fill the card (N = 187: 3 tiles x
    44 ranges = 132 blocks) and a large N keeps one range (N = 4,096: 528
    tiles).  Ties go to fewer ranges, whose counts are added atomically."""
    stages = max(1, -(-w // STAGE_WORDS))
    best = None
    for s in range(1, min(stages, 65535) + 1):
        plan = plan_for(w, s)
        key = (split_cost(n, plan), plan[0])
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


def trimatrix(bitmaps: torch.Tensor, plan: Optional[tuple] = None) -> torch.Tensor:
    """(N, W) int32 words on the card -> (N, N) int32 co-occurrence counts
    ``C[i, j] = sum_w popcount(B[i, w] & B[j, w])`` (full symmetric matrix;
    the diagonal holds the row supports).  ``plan`` (a :func:`plan_for`
    result) overrides :func:`split_plan`'s word split, for measuring it."""
    if bitmaps.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {bitmaps.device}")
    if bitmaps.ndim != 2 or bitmaps.dtype != torch.int32:
        raise ValueError(f"expected (N, W) int32 words, got "
                         f"{tuple(bitmaps.shape)} {bitmaps.dtype}")
    bitmaps = bitmaps.contiguous()
    n, w = bitmaps.shape
    if tile_count(n) >= 2**31:
        raise ValueError(f"N={n} exceeds the kernel's grid")
    if n == 0:
        return torch.empty((0, 0), dtype=torch.int32, device=bitmaps.device)
    out = launch_trimatrix(bitmaps, split_plan(n, w) if plan is None else plan)
    trimatrix.launches += 1
    return out


def launch_trimatrix(bitmaps: torch.Tensor, plan: tuple) -> torch.Tensor:
    """One launch of the kernel on contiguous (N > 0, W) int32 words with
    the word split ``plan``, counted on no wrapper: :func:`trimatrix`'s
    body, and the tuner's launches (``kernels.autotune``, which counts them
    itself)."""
    n, w = bitmaps.shape
    splits, split_words = plan
    # several ranges add their counts into a zeroed matrix
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc((n, n), dtype=torch.int32, device=bitmaps.device)
    stream = torch.cuda.current_stream(bitmaps.device).cuda_stream
    code = _lib().trimatrix_launch(ctypes.c_void_p(bitmaps.data_ptr()),
                                   ctypes.c_void_p(out.data_ptr()), n, w,
                                   splits, split_words, bitmaps.device.index,
                                   ctypes.c_void_p(stream))
    _build.check(code, "trimatrix_wgmma_kernel")
    return out


trimatrix.launches = 0

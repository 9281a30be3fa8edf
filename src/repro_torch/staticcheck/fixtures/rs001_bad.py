"""RS001 must-fail fixture: a runtime invariant guarded by bare ``assert``.

The bug class: under ``python -O`` (an optimized run) this check vanishes
and corrupt state flows downstream silently, with nothing raised.
Never imported — the gate lints it and must report RS001.
"""
import numpy as np


def validate_ring(words: np.ndarray, n_items: int, n_words: int) -> None:
    assert words.shape == (n_items, n_words)  # stripped under python -O
    assert words.dtype == np.uint32

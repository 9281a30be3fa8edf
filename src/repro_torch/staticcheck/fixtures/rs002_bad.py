"""RS002 must-fail fixture: ``np.empty`` slot buffer later gathered.

The slot-corruption bug class: a pair whose device id falls outside the
grouping loop leaves its slot uninitialized, and the gather reads
garbage as a valid index.  Never imported — the gate lints it and
must report RS002.
"""
import numpy as np


def build_slots(q: int, device_of_pair: np.ndarray, qmax: int) -> np.ndarray:
    slot_of_pair = np.empty(q, np.int64)        # garbage if a slot is missed
    extra = np.empty((q, 2), dtype=np.int32)    # same class, dtype kwarg
    for dev in range(int(device_of_pair.max()) + 1):
        idx = np.nonzero(device_of_pair == dev)[0]
        slot_of_pair[idx] = dev * qmax + np.arange(idx.shape[0])
        extra[idx, 0] = dev
    return slot_of_pair

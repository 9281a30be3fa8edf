"""RS005 must-fail fixture: undeclared host<->device conversions in a
declared hot path (the port's rule).

A slide loop that reads a count back with ``.item()``, the survivors'
mask with ``.cpu()``, and hands the ring a host tensor with no explicit
move — each a wait for the card (or an implicit copy) that no Layer-3
budget declares.  Never imported: the gate lints it and must report RS005.
"""
# staticcheck: hot-path
import torch


def advance(state, new_block, counts: torch.Tensor, mask: torch.Tensor):
    n_frequent = counts.sum().item()            # a read of the device count
    keep = mask.cpu()                           # the mask copied back
    state.ring.copy_(torch.from_numpy(new_block))   # no explicit .to(device)
    return n_frequent, keep

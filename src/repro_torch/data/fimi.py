"""FIMI-format transaction files (retail.dat et al.): the reference
package's ``data/fimi.py``, kept here so the port imports nothing of it.

The FIMI repository (fimi.uantwerpen.be) and SPMF distribute transaction
databases as plain text: one transaction per line, items as base-10
integers separated by whitespace.  Real files are ragged (every line its
own length), may carry trailing whitespace or CRLF endings, and sometimes
blank lines; item ids are non-negative but need not be dense or sorted.

This module parses that format into the same ``List[List[int]]`` the
in-memory generators produce, so a downloaded ``retail.dat`` drops
straight into ``pack_transactions`` / ``mine()`` and results become
comparable to the published literature instead of only to the synthetic
Table-2 shapes (tests assert bit-exact parity of the two ingestion
paths).  ``write_fimi`` is the inverse, used by the round-trip tests and
to export generated datasets for external tools.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

__all__ = ["parse_fimi", "load_fimi", "write_fimi", "fimi_universe"]


def parse_fimi(lines: Iterable[str]) -> List[List[int]]:
    """Parse FIMI lines into transactions (sorted, deduplicated item lists).

    Blank (or whitespace-only) lines are skipped — they are separators,
    not empty transactions; a file of N item lines yields exactly the N
    transactions every published parser reads from it.  Non-integer tokens
    and negative ids are rejected with the 1-based line number.
    """
    txns: List[List[int]] = []
    for ln, line in enumerate(lines, 1):
        toks = line.split()          # any whitespace runs, strips \r\n too
        if not toks:
            continue
        try:
            items = [int(t) for t in toks]
        except ValueError as e:
            raise ValueError(f"FIMI line {ln}: non-integer token ({e})") from None
        if any(i < 0 for i in items):
            raise ValueError(f"FIMI line {ln}: negative item id")
        txns.append(sorted(set(items)))
    return txns


def fimi_universe(txns: Sequence[Sequence[int]]) -> int:
    """Item-universe size for parsed transactions: ``max id + 1`` (FIMI ids
    index from 0 or 1 depending on the dataset; the bitmap encoder only
    needs an upper bound, so dense re-labeling is unnecessary)."""
    return max((max(t) for t in txns if t), default=-1) + 1


def load_fimi(path: str) -> Tuple[List[List[int]], int]:
    """Read a ``.dat`` file -> ``(transactions, n_items)``."""
    with open(path) as f:
        txns = parse_fimi(f)
    return txns, fimi_universe(txns)


def write_fimi(path: str, transactions: Sequence[Sequence[int]]) -> None:
    """Write transactions in FIMI format (space-separated, one per line).

    Items are written as given — unsorted or duplicated inputs survive the
    trip because parsing normalizes and the packed bitmap is OR-idempotent
    (the round-trip contract is bitmap equality, not byte equality).
    """
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for t in transactions:
            f.write(" ".join(str(int(i)) for i in t) + "\n")
    os.replace(tmp, path)

"""The port's FIMI-format ingestion against the reference package's, on the
CPU: the same text parses to the same transactions with the same errors,
written files are byte-identical, a file round-trips bit-exactly through
``pack_transactions``, and ``launch.mine --fimi`` prints the line the
reference's ``launch.mine`` prints.  ``tests/test_fimi.py`` (the
reference's own tests) is the checklist.
"""
import re

import numpy as np
import pytest

from repro.data import load_fimi as j_load_fimi
from repro.data import parse_fimi as j_parse_fimi
from repro.data import write_fimi as j_write_fimi
from repro.data import generate as j_generate
from repro.launch import mine as j_mine_cli

from repro_torch.core import EclatConfig, apriori_mine, mine
from repro_torch.core import bitmap as bm
from repro_torch.data import (fimi_universe, generate, load_fimi, parse_fimi,
                              write_fimi)
from repro_torch.launch import mine as mine_cli

NOISY = [
    "30 31 32   \n",          # trailing run of spaces
    "\n",                     # blank separator, not an empty txn
    "33 34 35 36 38 39 40 41 42\r\n",   # CRLF + ragged (long)
    "   \t \n",               # whitespace-only separator
    "38\n",                   # singleton line
    "39 38 39 32\t\n",        # unsorted + duplicate + trailing tab
    "48 39 47 48",            # no final newline
]


def test_roundtrip_bit_exact(tmp_path):
    txns, spec = generate("T10I4D100K", scale=0.005, seed=3)
    path = str(tmp_path / "retail_style.dat")
    write_fimi(path, txns)
    parsed, n_items = load_fimi(path)
    assert len(parsed) == len(txns) and n_items <= spec.n_items
    a = bm.pack_transactions(txns, spec.n_items)
    b = bm.pack_transactions(parsed, spec.n_items)
    assert a.dtype == b.dtype == np.uint32
    assert np.array_equal(a, b)
    assert (parsed, n_items) == j_load_fimi(path)


def test_parse_ragged_blank_and_whitespace():
    txns = parse_fimi(NOISY)
    assert txns == [[30, 31, 32],
                    [33, 34, 35, 36, 38, 39, 40, 41, 42],
                    [38],
                    [32, 38, 39],
                    [39, 47, 48]]
    assert txns == j_parse_fimi(NOISY)
    assert fimi_universe(txns) == 49


def test_noisy_file_matches_clean_memory_path(tmp_path):
    clean = [[1, 2, 5], [0, 7], [3], [2, 5, 6, 7]]
    path = str(tmp_path / "noisy.dat")
    with open(path, "w") as f:
        f.write("1 2 5  \n\n0 7\r\n3\n   \n2 5 6 7 2\t\n")
    parsed, n_items = load_fimi(path)
    assert n_items == 8
    assert np.array_equal(bm.pack_transactions(parsed, 8),
                          bm.pack_transactions(clean, 8))


@pytest.mark.parametrize("lines,match", [
    (["1 2\n", "3 x 4\n"], "line 2"), (["1 -2\n"], "negative"),
    (["\n", "\n", "4 5.5\n"], "line 3"), (["7 0x10\n"], "non-integer")])
def test_bad_tokens_raise_the_references_messages(lines, match):
    with pytest.raises(ValueError, match=match) as got:
        parse_fimi(lines)
    with pytest.raises(ValueError) as want:
        j_parse_fimi(lines)
    assert str(got.value) == str(want.value)


def test_empty_file(tmp_path):
    assert parse_fimi([]) == [] and fimi_universe([]) == 0
    path = tmp_path / "empty.dat"
    path.write_text("")
    assert load_fimi(str(path)) == ([], 0) == j_load_fimi(str(path))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_equals_reference_on_random_text(seed):
    """Random ragged lines with every separator the format allows."""
    rng = np.random.default_rng(seed)
    seps = [" ", "  ", "\t", " \t "]
    lines = []
    for _ in range(200):
        items = rng.integers(0, 500, rng.integers(0, 12)).tolist()
        line = "".join(f"{seps[rng.integers(len(seps))]}{i}" for i in items)
        lines.append(line + ("\r\n" if rng.random() < 0.3 else "\n"))
    assert parse_fimi(lines) == j_parse_fimi(lines)


def test_written_files_are_the_references_bytes(tmp_path):
    """Items as given (unsorted, duplicated), one line each, and the
    atomic rename leaves no temporary file."""
    txns = [[3, 1, 1], [], [0], [9, 2]]
    write_fimi(str(tmp_path / "port.dat"), txns)
    j_write_fimi(str(tmp_path / "ref.dat"), txns)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "ref.dat").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.dat", "ref.dat"]


def test_mining_parity_file_vs_memory(tmp_path):
    txns, spec = j_generate("chess", scale=0.03, seed=2)
    path = str(tmp_path / "chess.dat")
    write_fimi(path, txns)
    parsed, n_items = load_fimi(path)
    cfg = EclatConfig(min_sup=0.9, variant="v4", p=3)
    mem = mine(txns, spec.n_items, cfg, device="cpu").support_map()
    fil = mine(parsed, n_items, cfg, device="cpu").support_map()
    assert mem == fil
    assert apriori_mine(parsed, n_items, 0.9, device="cpu").support_map == fil


def _line(text):
    """The ``[mine]`` line with its time left out."""
    (line,) = [ln for ln in text.splitlines() if ln.startswith("[mine]")]
    return re.sub(r"in \d+\.\d+s", "in Ts", line)


@pytest.mark.parametrize("flags", [[], ["--mode", "closed"],
                                   ["--variant", "v6"]])
def test_launch_mine_fimi_line_equals_the_references(tmp_path, capsys, flags):
    txns, _ = j_generate("T10I4D100K", scale=0.003, seed=1)
    path = str(tmp_path / "t10.dat")
    write_fimi(path, txns)
    args = ["--fimi", path, "--min-sup", "0.05"] + flags
    mine_cli.main(args + ["--device", "cpu"])
    got = _line(capsys.readouterr().out)
    j_mine_cli.main(args)
    want = _line(capsys.readouterr().out)
    assert got == want
    assert got.startswith("[mine] t10.dat min_sup=0.05 ")

"""``launch.mine --top-k`` and ``--min-conf`` of the port against the
reference package's driver on the CPU: the same command line prints the
same ``[mine]`` lines, timings left out (chess at the command line's defaults:
scale 0.25, min_sup 0.8, v4).  And ``top_k_mine``'s ``device``,
``min_len`` and ``mesh`` are keyword-only, so a positional call written for
the reference (whose fifth parameter is ``mesh``) fails loudly."""
import re

import pytest

from repro.launch import mine as j_mine_cli
from repro_torch.core import EclatConfig, top_k_mine
from repro_torch.launch import mine as mine_cli


def _lines(text, directory=None):
    """The ``[mine]`` lines with times (and a checkpoint directory) left
    out."""
    lines = [re.sub(r"in \d+\.\d+s", "in Ts", ln)
             for ln in text.splitlines() if ln.startswith("[mine]")]
    return [ln.replace(directory, "DIR") for ln in lines] if directory else lines


def _both(capsys, args):
    mine_cli.main(args + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    j_mine_cli.main(args)
    return got, _lines(capsys.readouterr().out)


def test_top_k_prints_the_reference_ladder_and_itemsets(capsys):
    got, want = _both(capsys, ["--dataset", "chess", "--top-k", "10"])
    assert got == want
    assert len(got) == 11
    assert got[0].startswith("[mine] chess x0.25 top-10 (10 returned) in Ts: ladder [")


def test_min_conf_prints_the_reference_rule_count(capsys):
    got, want = _both(capsys, ["--dataset", "chess", "--min-conf", "0.9"])
    assert got == want
    assert len(got) == 2 and got[1].endswith("rules at conf>=0.9")


def test_top_k_takes_no_rules_as_in_the_reference(capsys):
    got, want = _both(capsys, ["--dataset", "chess", "--top-k", "3",
                               "--min-conf", "0.9"])
    assert got == want
    assert len(got) == 4 and not any("rules" in ln for ln in got)


def test_restore_prints_the_reference_rules(tmp_path, capsys):
    """Each package mines with a checkpoint per level, then restores the
    deepest one with ``--min-conf``: the same resumed and rules lines."""
    mine_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    base = ["--dataset", "chess"]          # levels 1-3: a checkpoint at level 3
    mine_cli.main(base + ["--device", "cpu", "--checkpoint-dir", mine_dir])
    j_mine_cli.main(base + ["--checkpoint-dir", ref_dir])
    capsys.readouterr()
    restore = base + ["--restore", "--min-conf", "0.9"]
    mine_cli.main(restore + ["--device", "cpu", "--checkpoint-dir", mine_dir])
    got = _lines(capsys.readouterr().out, mine_dir)
    j_mine_cli.main(restore + ["--checkpoint-dir", ref_dir])
    want = _lines(capsys.readouterr().out, ref_dir)
    assert [re.sub(r"\(\w+\)", "(B)", ln) for ln in got] == \
        [re.sub(r"\(\w+\)", "(B)", ln) for ln in want]
    assert len(got) == 2 and got[1].endswith("rules at conf>=0.9")


def test_top_k_mine_refuses_the_reference_positional_order():
    db = [[0, 1, 2], [0, 1], [1, 2], [0, 2], [0, 1, 2]]
    cfg = EclatConfig(min_sup=1)
    with pytest.raises(TypeError):
        top_k_mine(db, 3, 2, cfg, None)          # the reference's (…, config, mesh)
    with pytest.raises(TypeError):
        top_k_mine(db, 3, 2, cfg, "cpu", 1)      # the old (…, device, min_len)
    got = top_k_mine(db, 3, 2, cfg, device="cpu", min_len=2, mesh=None)
    assert len(got.itemsets) == 2 and all(len(s) >= 2 for s, _ in got.itemsets)

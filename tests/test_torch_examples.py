"""The port's examples (``python -m repro_torch.examples.<name>``) against
the reference's (``examples/<name>.py``) at ``tests/test_examples.py``'s
reduced sizes, on the CPU: the same lines, the itemset and rule counts
included, with only the times left out.  The port's run in this process
with ``--device cpu``; the reference's run as ``tests/test_examples.py``
runs them.  The LM examples' weights are random in each package (a
``torch.Generator`` against ``jax.random``), so their losses and generated
tokens are left out too; their parameter counts, requests and packing are
compared, and the port's ``tiny`` loss must fall.
"""
import os
import re
import subprocess
import sys

import pytest

from repro_torch.examples import (mine_distributed, quickstart, serve_lm,
                                  stream_topk, train_lm)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ENV = dict(os.environ, PYTHONPATH="src")


def _reference(args, timeout=600):
    r = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                       env=ENV, cwd=ROOT, timeout=timeout)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _port(main, argv, capsys):
    main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _untimed(text):
    """The lines with their times and the speedup (a ratio of times) left
    out."""
    text = re.sub(r"\d+\.\d+s\b", "Ts", text)
    return re.sub(r"speedup \d+\.\dx", "speedup Rx", text).splitlines()


@pytest.mark.parametrize("flags,marker", [
    (["--dataset", "mushroom", "--min-sup", "0.4", "--scale", "0.1"],
     "frequent itemsets"),
    (["--dataset", "chess", "--min-sup", "0.85", "--scale", "0.1", "--rules"],
     "association rules at conf>=0.9"),
    (["--dataset", "mushroom", "--min-sup", "0.4", "--scale", "0.1",
      "--compare-apriori"], "(results identical)")])
def test_quickstart_matches_the_reference(flags, marker, capsys):
    got = _port(quickstart.main, flags, capsys)
    want = _reference(["examples/quickstart.py"] + flags)
    assert marker in got
    assert _untimed(got) == _untimed(want)
    if "--rules" in flags:
        n_rules = int(got.split(" association rules")[0].rsplit("\n", 1)[-1])
        assert n_rules > 0
        for line in (ln for ln in got.splitlines() if "conf=" in ln):
            assert 0.9 <= float(line.split("conf=")[1].split()[0]) <= 1.0


def test_stream_topk_matches_the_reference(capsys):
    flags = ["--batches", "4", "--n-blocks", "2", "--block-txns", "128"]
    got = _port(stream_topk.main, flags, capsys)
    want = _reference(["examples/stream_topk.py"] + flags)
    assert "parity: windowed == batch mine()" in got
    assert got.splitlines() == want.splitlines()


def test_mine_distributed_matches_the_reference(capsys):
    got = _port(mine_distributed.main,
                ["--ranks", "2", "--dist-backend", "gloo", "--min-sup", "0.35"],
                capsys)
    want = _reference(["examples/mine_distributed.py", "--devices", "2",
                       "--min-sup", "0.35"])
    assert "recovered" in got
    # the reference counts devices, the port ranks
    assert got.splitlines() == want.replace(" on 2 devices;", " on 2 ranks;").splitlines()


def _unlossed(text):
    """The lines with times, losses and generated tokens left out."""
    text = re.sub(r"\d+\.\d+s/step", "Ts/step", text)
    text = re.sub(r"loss \d+\.\d+ -> \d+\.\d+", "loss A -> B", text)
    text = re.sub(r"checkpoints in [^)]*\)", "checkpoints in DIR)", text)
    text = re.sub(r"(req \d+): \[[-\d, ]*\]", r"\1: [TOKENS]", text)
    return _untimed(text)


def test_train_lm_matches_the_reference_and_its_loss_falls(tmp_path, capsys):
    flags = ["--steps", "20", "--batch", "4", "--seq", "32"]
    got = _port(train_lm.main, flags + ["--ckpt-dir", str(tmp_path / "t")], capsys)
    want = _reference(["examples/train_lm.py"] + flags +
                      ["--ckpt-dir", str(tmp_path / "j")])
    assert "training example OK" in got
    assert _unlossed(got) == _unlossed(want)
    first, last = map(float, re.search(r"loss (\d+\.\d+) -> (\d+\.\d+)",
                                        got).groups())
    assert last < first
    # a second run resumes from the final checkpoint of the first
    again = _port(train_lm.main, ["--steps", "2", "--batch", "4", "--seq", "32",
                                  "--ckpt-dir", str(tmp_path / "t")], capsys)
    assert "resumed from checkpoint at step 20" in again


def test_serve_lm_matches_the_reference(capsys):
    flags = ["--requests", "6", "--batches", "2", "--max-new", "4"]
    got = _port(serve_lm.main, flags, capsys)
    want = _reference(["examples/serve_lm.py"] + flags)
    assert "greedy-LPT packing efficiency" in got
    assert _unlossed(got) == _unlossed(want)
    assert len(re.findall(r"req \d+: \[", got)) == 3

"""The port's guard over the mining path (``repro_torch.staticcheck``)
against the reference's ``repro.staticcheck``, on the CPU.

Layer 1: the port's lint reports the reference's rule ids and lines on the
reference's committed fixtures, its torch RS005 flags the planted
conversions, and over the port it finds nothing unsuppressed, each
suppression naming a site of Layer 3's ``SYNC_BUDGET``.  Layer 3 on the
host: the audits give no finding and mine the same levels, itemsets and
padding as the reference on the same transactions (the reference run as
its own tests run it, ``backend="pallas"``).  Layer 2 on 4 gloo ranks:
every backend and the ring write keep their declared collectives, and each
of the four contract fixtures trips its rule.  Exact comparisons
throughout: the itemsets, counts and paddings are integers.
"""
import os
import textwrap

import numpy as np
import pytest
import torch

from repro.core.eclat import EclatConfig as JEclatConfig
from repro.core.eclat import mine as j_mine
from repro.staticcheck.astlint import lint_file as j_lint_file
from repro.staticcheck.shapes import _batches as j_batches
from repro.staticcheck.shapes import audit_mine as j_audit_mine
from repro.staticcheck.shapes import audit_streaming as j_audit_streaming
from repro.streaming.miner import StreamConfig as JStreamConfig
from repro.streaming.miner import StreamingMiner as JStreamingMiner
from repro_torch.dist import collectives as coll
from repro_torch.staticcheck import (check_sync_markers, iter_python_files,
                                     lint_file, lint_paths, sync_markers)
from repro_torch.staticcheck import __main__ as gate
from repro_torch.staticcheck import contracts, shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(ROOT, "src", "repro", "staticcheck", "fixtures")
PORT_FIXTURE = os.path.join(ROOT, "src", "repro_torch", "staticcheck", "fixtures",
                            "rs005_bad.py")


def _port_files():
    return iter_python_files(ROOT, [os.path.join("src", "repro_torch")])


# ---------------------------------------------------------------------------
# Layer 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rid", ["RS001", "RS002", "RS003", "RS004"])
def test_lint_matches_the_reference_on_its_fixtures(rid):
    path = os.path.join(REF_FIXTURES, f"{rid.lower()}_bad.py")
    got = [(f.rule, f.line) for f in lint_file(path, root=ROOT)]
    want = [(f.rule, f.line) for f in j_lint_file(path, root=ROOT)]
    assert got == want and any(r == rid for r, _ in got)


def test_torch_rs005_flags_the_planted_item_and_cpu():
    found = lint_file(PORT_FIXTURE, root=ROOT)
    lines = open(PORT_FIXTURE).read().splitlines()
    flagged = {lines[f.line - 1].split("#")[0].strip() for f in found}
    assert {f.rule for f in found} == {"RS005"}
    assert any(".item()" in s for s in flagged)
    assert any(".cpu()" in s for s in flagged)
    assert any("torch.from_numpy" in s for s in flagged)
    # the reference's RS005 (jnp/np conversions) sees nothing there
    assert j_lint_file(PORT_FIXTURE, root=ROOT) == []


def test_rs005_tells_host_values_from_tensor_reads(tmp_path):
    src = textwrap.dedent("""\
        # staticcheck: hot-path
        import numpy as np
        import torch

        def step(t: torch.Tensor, host: np.ndarray, dev):
            a = torch.from_numpy(host).to(dev)      # explicit move: clean
            b = torch.tensor(host, device=dev)      # explicit device: clean
            n = int(t.shape[0]) + len(host.tolist())  # host values: clean
            m = np.zeros(3)
            m.tolist()                              # a numpy read: clean
            s = t.sum()
            c = int(s)                              # a tensor read: RS005
            d = np.asarray(t)                       # a tensor read: RS005
            e = float(t.max())                      # a tensor read: RS005
            f = t.cpu().numpy()                     # one read: RS005 once
            # staticcheck: disable=RS005 sync=engine.mask_supports
            g = t.cpu()
            return a, b, n, c, d, e, f, g
    """)
    p = tmp_path / "hot.py"
    p.write_text(src)
    found = [(f.rule, f.line) for f in lint_file(str(p))]
    assert found == [("RS005", 12), ("RS005", 13), ("RS005", 14), ("RS005", 15)]


def test_the_port_lints_clean_and_every_suppression_is_a_declared_sync():
    files = _port_files()
    assert len(files) > 90
    findings = lint_paths(files, root=ROOT)
    findings += check_sync_markers(files, shapes.SYNC_BUDGET, root=ROOT)
    assert findings == [], "\n".join(f.format() for f in findings)
    markers = sync_markers(files, root=os.path.join(ROOT, "src"))
    assert sorted(m.site for m in markers) == sorted(shapes.SYNC_BUDGET)
    for m in markers:
        assert m.path == shapes.SYNC_BUDGET[m.site].path, m
    # the reads the hot path must make are exactly the suppressed ones
    suppressed = {m.site for m in markers if m.suppresses_rs005}
    assert {"engine.mask_supports", "tidsharded.mask_supports",
            "sharded.supports_gather", "grid.supports_gather",
            "triangular.counts_readback"} == suppressed


def test_sync_marker_check_catches_undeclared_declarations(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent("""\
        def f(t):
            a = t.cpu()  # staticcheck: disable=RS005
            b = t.cpu()  # staticcheck: disable=RS005 sync=no.such_site
            c = t.cpu()  # staticcheck: disable=RS005 sync=engine.mask_supports
            return a, b, c
    """))
    found = check_sync_markers([str(p)], {"engine.mask_supports", "other.site"})
    msgs = sorted((f.line, f.message.split(" ")[0]) for f in found)
    assert [line for line, _ in msgs] == [0, 2, 3]
    assert any("other.site" in f.message for f in found)


def test_the_port_calls_no_torch_compile():
    assert shapes.compile_findings() == []


# ---------------------------------------------------------------------------
# Layer 3 on the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,compact", [("ref", True), ("fused", True),
                                             ("ref", False), ("fused", False)])
def test_audit_mine_matches_the_reference(backend, compact):
    findings, summary = shapes.audit_mine(backend, compact=compact, device="cpu")
    assert findings == []
    assert summary["checks"] == ["SH001 (static: no torch.compile)", "SH003"]
    assert "SH002" in summary["not_checked"]
    j_findings, j_summary = j_audit_mine()
    assert j_findings == []
    assert (summary["levels"], summary["itemsets"]) == \
        (j_summary["levels"], j_summary["itemsets"])
    txns = j_batches(np.random.default_rng(1), 1, n_items=48, block_txns=512)[0]
    res = j_mine(txns, 48, JEclatConfig(min_sup=0.25, variant="v3", backend="pallas"))
    assert summary["counts"] == list(res.counts)
    assert summary["level_padding"] == [
        [lv["pairs"], lv["padded_to"]] for lv in res.stats["pair_padding"]["per_level"]]


@pytest.mark.parametrize("compact", [True, False])
def test_audit_streaming_matches_the_reference(compact):
    findings, summary = shapes.audit_streaming("fused", compact=compact, device="cpu")
    assert findings == []
    assert summary["audited_slides"] == 5
    j_findings, j_summary = j_audit_streaming(backend="pallas")
    assert j_findings == []
    assert summary["itemsets_last_slide"] == j_summary["itemsets_last_slide"]
    # the reference's audited stream replayed on its engine, slide by slide
    distinct = j_batches(np.random.default_rng(0), 5, n_items=48, block_txns=128)
    batches = [distinct[i % 5] for i in range(15)]
    miner = JStreamingMiner(48, JStreamConfig(min_sup=8, n_blocks=4, block_txns=128,
                                              backend="pallas"))
    for b in batches[:10]:
        miner.advance(b)
    assert summary["counts"] == [list(miner.advance(b).counts) for b in batches[10:]]
    assert summary["level_padding"] == [list(p) for p in miner.engine.level_padding]


def test_shape_fixture_on_the_host_gives_sh003():
    assert {f.rule for f in shapes.check_shape_fixture("cpu")} == {"SH003"}


def test_budget_units_compose_the_declared_syncs():
    assert shapes._expected({"level": 1}) == {"engine.pairs_upload": 1,
                                              "engine.mask_supports": 1}
    assert shapes._expected({"push": 1, "co-occurrence count": 2}) == {
        "window.block_upload": 1, "device.words_upload": 2,
        "triangular.counts_readback": 2}
    assert shapes._expected({"level": 1, "level without compaction": 1})[
        "engine.gather_upload"] == 1


# ---------------------------------------------------------------------------
# Layer 2 on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def contracts_run():
    return contracts.check_all_contracts("cpu", tuple(contracts.CONTRACT_FIXTURES))


@pytest.mark.parametrize("target", contracts.BACKENDS_CHECKED + (contracts.RING_WRITE,))
def test_contracts_hold_on_every_rank(contracts_run, target):
    findings, summary = contracts_run
    assert [f for f in findings if f.path.split(":")[1].split()[0] == target] == []
    counted = summary["targets"][target]["counted_rank0"]
    calls = {(a, op): c["calls"] for a, ops in counted.items() for op, c in ops.items()}
    assert calls == contracts.BUDGETS[target].collectives


def test_contracts_find_nothing(contracts_run):
    assert contracts_run[0] == []
    assert contracts_run[1]["ranks"] == contracts.RANKS


@pytest.mark.parametrize("name,rule", [("extra_psum", "IR001"),
                                       ("frontier_allgather", "IR001"),
                                       ("fat_psum", "IR002"),
                                       ("wrong_axis_psum", "IR003")])
def test_contract_fixtures_still_fail(contracts_run, name, rule):
    assert rule in contracts_run[1]["fixtures"][name]


def test_collective_widths_are_counted():
    coll.reset_collective_counts()
    assert coll.collective_widths() == {}


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a card")
def test_gate_without_device_cpu_raises_with_no_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gate.main([])


def test_gate_on_the_host(tmp_path):
    report = tmp_path / "findings.json"
    assert gate.main(["--device", "cpu", "--report", str(report)]) == 0
    assert report.exists()
    assert gate.main(["--device", "cpu", "--shape-fixture"]) == 1
    assert gate.main(["--device", "cpu", "--contract-fixture", "fat_psum"]) == 1
    assert gate.main(["--lint-target", PORT_FIXTURE]) == 1

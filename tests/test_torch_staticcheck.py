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


def test_the_gates_fixtures_are_the_ports_own():
    """Every must-fail fixture the port's gate lints lies under
    src/repro_torch, none under the reference's tree, and the gate's own
    fixture check finds each rule on its fixture."""
    port = os.path.join(ROOT, "src", "repro_torch") + os.sep
    assert sorted(gate.FIXTURES) == ["RS001", "RS002", "RS003", "RS004", "RS005"]
    for rid, path in gate.FIXTURES.items():
        assert os.path.abspath(path).startswith(port), (rid, path)
        assert os.path.isfile(path), path
    from repro_torch.staticcheck import Report
    report = Report()
    assert gate.run_lint_fixtures(report) == 0
    assert report.summary["lint_fixtures"] == {"checked": 5, "rotted": 0}


@pytest.mark.parametrize("rid", ["RS001", "RS002", "RS003", "RS004"])
def test_the_ports_fixture_copies_lint_as_the_references(rid):
    """The port's copy of a reference fixture gives the findings, rules and
    lines, that the reference's lint gives on the reference's file."""
    got = [(f.rule, f.line) for f in lint_file(gate.FIXTURES[rid], root=ROOT)]
    path = os.path.join(REF_FIXTURES, f"{rid.lower()}_bad.py")
    want = [(f.rule, f.line) for f in j_lint_file(path, root=ROOT)]
    assert got == want and any(r == rid for r, _ in got)


@pytest.mark.parametrize("rid", ["RS001", "RS002", "RS003", "RS004", "RS005"])
def test_the_gate_reports_each_rule_on_its_fixture(rid):
    """``python -m repro_torch.staticcheck --lint-target`` on a rule's
    fixture exits 1 and reports that rule."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.staticcheck",
                          "--lint-target", gate.FIXTURES[rid]], env=env,
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 1, res.stdout + res.stderr
    assert f": {rid} [error]" in res.stderr, res.stderr


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


# one audit_mine region recorded on the card (fused, compact=True): its
# record_function ranges, synchronising runtime calls and device-to-host
# copy calls as shapes.card_events gives them
RECORDED = os.path.join(ROOT, "tests", "data", "card_sync_events_mine.json")


def _recorded():
    import json
    with open(RECORDED) as fh:
        return [shapes.CardEvent(**e) for e in json.load(fh)["events"]]


def test_the_card_count_cuts_a_recorded_mine_region_at_its_levels():
    """The recorded region: each of its 3 levels synchronised twice (the
    pair upload's wait; the mask and supports' copy and its wait, one
    sync), the rest of the region twice, within SYNC_BUDGET's totals; the
    profiler's own device sync after the region is not counted."""
    events = _recorded()
    cut = shapes.cut_card_syncs(events)
    assert cut["levels"] == [{"syncs": 2, "d2h": 0, "total": 2}] * 3
    assert cut["outside"] == {"syncs": 2, "d2h": 0, "total": 2}
    assert any(e.name == "cudaDeviceSynchronize" for e in events)
    assert shapes.budget_total({"level": 1}) == 2
    for i, lv in enumerate(cut["levels"]):
        assert shapes.card_sync_findings("t", f"level {i + 2}", {"level": 1}, lv) == []
    assert shapes.card_sync_findings("t", "outside", {"co-occurrence count": 1},
                                     cut["outside"]) == []


@pytest.mark.parametrize("kind,name", [("sync", "cudaEventSynchronize"),
                                       ("sync", "cudaDeviceSynchronize"),
                                       ("d2h", "cudaMemcpyAsync")])
def test_a_sync_beyond_the_budget_in_a_level_is_a_finding(kind, name):
    """One more synchronising call, or a device-to-host copy no wait
    follows, inside the recorded region's second level: that level's count
    exceeds its budget total, an SH002 finding through the profiler's
    count; the other levels and the rest of the region are unchanged."""
    events = _recorded()
    levels = [e for e in events if e.kind == "range" and e.name == shapes.LEVEL]
    t = (levels[1].start + levels[1].end) / 2
    planted = sorted(events + [shapes.CardEvent(kind, name, t, t + 1.0)],
                     key=lambda e: (e.start, e.kind != "range"))
    cut = shapes.cut_card_syncs(planted)
    assert [lv["total"] for lv in cut["levels"]] == [2, 3, 2]
    assert cut["outside"]["total"] == 2
    found = shapes.card_sync_findings("t", "level 3", {"level": 1}, cut["levels"][1])
    assert [f.rule for f in found] == ["SH002"] and "profiler" in found[0].message


def test_the_card_count_cuts_slides_and_pairs_a_copy_with_its_wait():
    """Two slides, each with a level: a device-to-host copy followed by a
    wait is one sync, a copy with no wait after it one, an event wait one;
    what lies between the slides is no slide's."""
    E = shapes.CardEvent
    events = [E("range", shapes.SLIDE, 0, 100), E("range", shapes.LEVEL, 10, 50),
              E("d2h", "cudaMemcpyAsync", 20, 21), E("sync", "cudaStreamSynchronize", 22, 23),
              E("d2h", "cudaMemcpyAsync", 60, 61),
              E("sync", "cudaStreamSynchronize", 150, 151),
              E("range", shapes.SLIDE, 200, 300), E("range", shapes.LEVEL, 210, 250),
              E("range", shapes.LEVEL, 260, 290), E("sync", "cudaEventSynchronize", 270, 271)]
    slides = shapes.cut_card_slides(events)
    assert slides == [
        {"levels": [{"syncs": 1, "d2h": 0, "total": 1}],
         "outside": {"syncs": 0, "d2h": 1, "total": 1}},
        {"levels": [{"syncs": 0, "d2h": 0, "total": 0},
                    {"syncs": 1, "d2h": 0, "total": 1}],
         "outside": {"syncs": 0, "d2h": 0, "total": 0}}]
    units = {"push": 1, "co-occurrence count": 2}
    assert shapes.budget_total(units) == 5
    assert shapes.card_sync_findings("t", "slide", units, slides[0]["outside"]) == []


def test_card_events_read_a_profiler_trace():
    """The profiler's events as the card gave them (names, device types and
    correlation ids of torch 2.11's trace): the marks, the synchronising
    calls, and the copy calls whose device copy runs device to host."""
    from types import SimpleNamespace as NS

    def ev(name, device, id_, start):
        return NS(name=name, device_type=f"DeviceType.{device}", id=id_,
                  time_range=NS(start=start, end=start + 1))

    class Prof:
        def events(self):
            return [ev(shapes.REGION, "CPU", 1, 0), ev("cudaLaunchKernel", "CPU", 18, 2),
                    ev("cudaMemcpyAsync", "CPU", 26, 3),
                    ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 26, 4),
                    ev("cudaMemcpyAsync", "CPU", 30, 5),
                    ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 30, 6),
                    ev("cudaStreamSynchronize", "CPU", 31, 7),
                    ev("aten::_local_scalar_dense", "CPU", 30, 5)]
    assert [(e.kind, e.name) for e in shapes.card_events(Prof())] == [
        ("range", shapes.REGION), ("d2h", "cudaMemcpyAsync"),
        ("sync", "cudaStreamSynchronize")]


def test_the_card_sync_fixture_is_not_counted_on_the_host():
    findings, seen = shapes.check_card_sync_fixture("cpu")
    assert findings == [] and seen["card"] is None and seen["warn_mode"] is None
    assert seen["not_checked"].startswith("not counted there")


def test_the_audits_count_no_card_sync_on_the_host():
    _, summary = shapes.audit_mine("ref", device="cpu")
    assert summary["syncs"]["per_level"] == []
    assert summary["syncs"]["outside_levels"]["card"] is None
    assert "profiler" in summary["not_checked"]


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

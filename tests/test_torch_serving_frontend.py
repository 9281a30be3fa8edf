"""The port's asynchronous FIM serving front end (``ServingFrontend``,
``loadgen``) against the reference package (``tests/test_serving_frontend.py``'s
cases that ``test_torch_streaming.py`` does not already hold), on the CPU:
version stamps that survive a ``MinerState`` round trip, the heartbeat and
stall reporting, batched answers equal to the synchronous path and to the
reference front end's at the same version, backpressure, lifecycle, readers
racing a writer thread, restore from a crashed run, and the ``--serve`` /
``--workload fim`` command lines.  Answers are compared exactly (by value
and by ``answer_checksum``).
"""
import contextlib
import io
import re
import threading
import time

import pytest

from faultinject import crashed_run as j_crashed_run
from faultinject import make_batches
from repro.launch import serve as j_serve_cli
from repro.serving import ServingFrontend as JFrontend
from repro.serving import answer_checksum as j_answer_checksum
from repro.serving import query_mix as j_query_mix
from repro.streaming import StreamConfig as JStreamConfig
from repro.streaming import StreamingMiner as JMiner

from repro_torch.faults import InjectedFault, clear_kill_hook, set_kill_hook
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import stream as stream_cli
from repro_torch.serving import (AdmissionConfig, ItemsetQuery, QueryShed,
                                 ServingFrontend, StreamQueryService,
                                 answer_checksum, answer_query, query_mix,
                                 run_storm, verify_storm)
from repro_torch.streaming import (StreamCheckpointer, StreamConfig,
                                   StreamingMiner)
from repro_torch.training import Heartbeat, HeartbeatMonitor, WriterStalledError

N_ITEMS = 12
CFG = dict(min_sup=5, n_blocks=3, block_txns=32, bucket_min=16)


def _miner(backend="ref"):
    return StreamingMiner(N_ITEMS, StreamConfig(backend=backend, **CFG),
                          keep_transactions=False, device="cpu")


def _batches(n, seed=0):
    return make_batches(n, 24, seed=seed, n_items=N_ITEMS)


def test_window_version_roundtrips_through_miner_state():
    miner = _miner()
    for b in _batches(3):
        miner.advance(b)
    restored = StreamingMiner.from_state(miner.snapshot_state(),
                                         keep_transactions=False, device="cpu")
    assert restored.window_version == 3
    assert restored.advance(_batches(1, seed=7)[0]).version == 4


def test_crashed_slide_publishes_no_version():
    miner = _miner()
    batches = _batches(3)
    for b in batches[:2]:
        miner.advance(b)

    def die(name):
        if name == "miner:mid_append":
            raise InjectedFault(name)
    set_kill_hook(die)
    try:
        with pytest.raises(InjectedFault):
            miner.advance(batches[2])
    finally:
        clear_kill_hook()
    assert miner.window_version == 2


def test_heartbeat_monitor_latches_and_reports():
    t = {"now": 0.0}
    hb = Heartbeat(clock=lambda: t["now"])
    fired = []
    mon = HeartbeatMonitor(hb, timeout_s=1.0, on_stall=fired.append, name="w")
    t["now"] = 0.9
    assert not mon.check()
    hb.beat(step=3)
    t["now"] = 1.8
    assert not mon.check()
    t["now"] = 3.0
    assert mon.check()
    with pytest.raises(WriterStalledError, match="no heartbeat"):
        mon.assert_alive()
    hb.beat(step=4)
    assert mon.check()
    assert len(fired) == 1 and fired[0]["last_step"] == 3
    with pytest.raises(ValueError):
        HeartbeatMonitor(hb, timeout_s=0)


def test_wait_for_version_reports_stalled_writer():
    frontend = ServingFrontend(_miner(), AdmissionConfig(stall_timeout_s=0.05))
    try:
        with pytest.raises(WriterStalledError):
            frontend.wait_for_version(1, timeout=5.0, poll_s=0.01)
        assert frontend.writer_stalled
        assert frontend.metrics.summary()["n_stalls"] >= 1
    finally:
        frontend.stop()


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_frontend_matches_synchronous_and_reference_answers(backend):
    """Every batched answer equals the synchronous one at its version, and
    the reference front end's answer to the same query on the same window."""
    frontend = ServingFrontend(_miner(backend), AdmissionConfig())
    ref = JFrontend(JMiner(N_ITEMS, JStreamConfig(
        backend={"ref": "jnp", "fused": "pallas"}[backend], **CFG),
        keep_transactions=False))
    try:
        batch = _batches(1)[0]
        frontend.ingest(batch)
        ref.ingest(batch)
        queries = query_mix(20, seed=2)
        assert queries == [ItemsetQuery(**vars(q)) for q in j_query_mix(20, seed=2)]
        tickets = frontend.submit_many(queries)
        j_tickets = ref.submit_many(j_query_mix(20, seed=2))
        for q, ticket, j_ticket in zip(queries, tickets, j_tickets):
            answer, version = ticket.result(timeout=30.0)
            j_answer, j_version = j_ticket.result(timeout=30.0)
            assert version == j_version == frontend.window_version == 1
            direct, _ = answer_query(frontend.snapshot_at(version), q, cache=None)
            assert answer == direct == j_answer
            assert answer_checksum(answer) == j_answer_checksum(j_answer)
    finally:
        frontend.stop()
        ref.stop()


def test_shed_policy_sheds_and_queued_queries_stay_consistent():
    frontend = ServingFrontend(_miner(), AdmissionConfig(max_queue=4, policy="shed"),
                               auto_start=False)
    frontend.ingest(_batches(1)[0])
    queries = query_mix(6, seed=3)
    frontend._running = True                 # admit without a drain worker
    admitted, shed = [], 0
    for q in queries:
        try:
            admitted.append(frontend.submit(q))
        except QueryShed:
            shed += 1
    assert len(admitted) == 4 and shed == 2
    assert frontend.metrics.summary()["n_shed"] == 2
    frontend._running = False
    frontend.start()
    try:
        for t in admitted:
            answer, version = t.result(timeout=30.0)
            direct, _ = answer_query(frontend.snapshot_at(version), t.query,
                                     cache=None)
            assert answer == direct
    finally:
        frontend.stop()


def test_block_policy_bounded_wait_then_shed():
    frontend = ServingFrontend(
        _miner(), AdmissionConfig(max_queue=1, policy="block", block_timeout_s=0.1),
        auto_start=False)
    frontend._running = True
    frontend.submit(ItemsetQuery(qid=0))
    t0 = time.perf_counter()
    with pytest.raises(QueryShed, match="timed out"):
        frontend.submit(ItemsetQuery(qid=1))
    assert time.perf_counter() - t0 >= 0.1
    frontend._running = False


def test_stop_fails_pending_tickets_instead_of_hanging():
    frontend = ServingFrontend(_miner(), AdmissionConfig(), auto_start=False)
    frontend._running = True
    ticket = frontend.submit(ItemsetQuery(qid=0))
    frontend.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        ticket.result(timeout=1.0)
    with pytest.raises(RuntimeError, match="not running"):
        frontend.submit(ItemsetQuery(qid=1))
    with pytest.raises(ValueError):
        AdmissionConfig(policy="drop")


def test_concurrent_readers_each_see_one_consistent_version():
    frontend = ServingFrontend(
        _miner("fused"), AdmissionConfig(keep_versions=16, max_wait_s=0.001))
    batches = _batches(8, seed=11)
    frontend.ingest(batches[0])
    try:
        wt = threading.Thread(target=lambda: [frontend.ingest(b) for b in batches[1:]],
                              daemon=True)
        queries = query_mix(60, seed=4)
        wt.start()
        outcome = run_storm(frontend, queries, n_clients=4, timeout_s=60.0)
        wt.join(timeout=60.0)
        assert not wt.is_alive()
        assert outcome["errors"] == {} and not outcome["shed"]
        assert sorted(outcome["answers"]) == [q.qid for q in queries]
        assert {v for _, v in outcome["answers"].values()} <= set(range(1, 9))
        assert frontend.window_version == 8
        ver = verify_storm(frontend, queries, outcome)
        assert ver["verified"] == len(queries) and not ver["unverifiable"]
    finally:
        frontend.stop()


def test_interleaving_consistency_under_shed_pressure():
    frontend = ServingFrontend(
        _miner(), AdmissionConfig(max_queue=2, policy="shed", max_wait_s=0.02,
                                  keep_versions=16))
    batches = _batches(5, seed=13)
    frontend.ingest(batches[0])
    try:
        wt = threading.Thread(target=lambda: [frontend.ingest(b) for b in batches[1:]],
                              daemon=True)
        wt.start()
        queries = query_mix(80, seed=5)
        outcome = run_storm(frontend, queries, n_clients=8, timeout_s=60.0)
        wt.join(timeout=60.0)
        assert outcome["errors"] == {}
        assert set(outcome["answers"]) | set(outcome["shed"]) == {q.qid for q in queries}
        assert verify_storm(frontend, queries, outcome)["verified"] == len(outcome["answers"])
    finally:
        frontend.stop()


def test_stress_many_clients_short_switch_interval():
    """More client threads than cores and a shortened switch interval while
    a writer slides: every query is answered exactly once and counted once
    (a lost update in the queue or the metrics breaks the totals), and
    every answer verifies at its version."""
    import os
    import sys
    frontend = ServingFrontend(_miner(), AdmissionConfig(keep_versions=16,
                                                         max_wait_s=0.0005))
    batches = _batches(5, seed=21)
    frontend.ingest(batches[0])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        wt = threading.Thread(target=lambda: [frontend.ingest(b) for b in batches[1:]],
                              daemon=True)
        wt.start()
        queries = query_mix(96, seed=8)
        outcome = run_storm(frontend, queries,
                            n_clients=max(2 * (os.cpu_count() or 1), 8) + 1,
                            timeout_s=60.0)
        wt.join(timeout=60.0)
        assert not wt.is_alive()
        assert outcome["errors"] == {} and not outcome["shed"]
        assert sorted(outcome["answers"]) == [q.qid for q in queries]
        m = frontend.metrics.summary()
        assert m["n_answered"] == len(queries) and m["n_errors"] == 0
        assert verify_storm(frontend, queries, outcome)["verified"] == len(queries)
    finally:
        sys.setswitchinterval(interval)
        frontend.stop()


def test_verify_storm_raises_on_a_divergent_answer():
    frontend = ServingFrontend(_miner(), AdmissionConfig())
    try:
        frontend.ingest(_batches(1)[0])
        queries = query_mix(4, seed=1)
        outcome = run_storm(frontend, queries, n_clients=2)
        qid = queries[0].qid
        answer, version = outcome["answers"][qid]
        outcome["answers"][qid] = (("tampered",), version)
        with pytest.raises(RuntimeError, match="serving divergence"):
            verify_storm(frontend, queries, outcome)
    finally:
        frontend.stop()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_frontend_restores_from_crashed_run_and_serves_identically(writer, tmp_path):
    """A front end restored from a crashed run's checkpoint (written by
    either package) answers right away from the restored window, then,
    after the replay, exactly as a server that never crashed."""
    batches = _batches(4, seed=42)
    if writer == "reference":
        j_crashed_run(N_ITEMS, JStreamConfig(backend="jnp", **CFG), batches,
                      str(tmp_path), "miner:mid_append", kill_slide=2)
    else:
        miner = _miner()
        ck = StreamCheckpointer(str(tmp_path))
        for i, b in enumerate(batches[:2]):
            miner.advance(b)
            ck.save(miner, i + 1)
            ck.wait()
    ref = StreamQueryService(_miner())
    for b in batches:
        ref.ingest(b)
    frontend, completed = ServingFrontend.from_checkpoint(
        str(tmp_path), config=AdmissionConfig(keep_versions=16), device="cpu")
    try:
        assert completed == 2 and frontend.window_version == 2
        assert len(frontend.snapshot.itemsets) > 0
        for b in batches[completed:]:
            frontend.ingest(b)
        assert frontend.window_version == ref.window_version == 4
        queries = query_mix(24, seed=6)
        for q, t in zip(queries, frontend.submit_many(queries)):
            answer, version = t.result(timeout=30.0)
            assert version == 4
            assert answer == answer_query(ref.snapshot, q, cache=None)[0]
    finally:
        frontend.stop()


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


FIM = ["--workload", "fim", "--n-blocks", "2", "--block-txns", "128",
       "--min-sup", "0.05", "--queries", "40", "--slides", "3",
       "--slide-gap-ms", "0"]


def test_serve_fim_restored_answers_equal_the_references(tmp_path):
    """``launch.serve --workload fim --restore`` of one checkpoint in both
    packages: no writer runs, so every answer is at the restored version and
    the verified digests (query, version, answer checksum) are equal."""
    code, _ = _run(stream_cli.main, ["--dataset", "T10I4D100K", "--min-sup", "0.05",
                                     "--block-txns", "128", "--n-blocks", "2",
                                     "--batches", "3", "--device", "cpu",
                                     "--checkpoint-dir", str(tmp_path)])
    assert code == 0
    restore = FIM + ["--checkpoint-dir", str(tmp_path), "--restore"]
    code, got = _run(serve_cli.main, restore + ["--device", "cpu"])
    j_code, want = _run(j_serve_cli.main, restore)
    assert code == j_code == 0
    digest = [re.search(r"checksum (\w+)", ln).group(1) for ln in (got[-1], want[-1])]
    assert digest[0] == digest[1]
    assert got[0].split(" — ")[0] == want[0].split(" — ")[0]


def test_serve_fim_storm_under_a_writer():
    code, lines = _run(serve_cli.main, FIM + ["--device", "cpu"])
    assert code == 0
    assert "answered 40/40 (shed 0, errors 0)" in lines[1]
    assert "final window_version=3" in lines[2]
    assert re.search(r"verified 40 answers bit-identical", lines[3])


def test_launch_stream_serve_verifies_its_storm(tmp_path):
    args = ["--dataset", "T10I4D100K", "--min-sup", "0.05", "--block-txns", "128",
            "--n-blocks", "2", "--batches", "4", "--device", "cpu", "--serve",
            "--serve-queries", "30", "--checkpoint-dir", str(tmp_path)]
    code, lines = _run(stream_cli.main, args)
    assert code == 0
    assert sum("version=" in ln for ln in lines if "slide" in ln) == 4
    assert any("answered 30/30" in ln for ln in lines)
    assert any("verified 30 answers" in ln and "final window_version=4" in ln
               for ln in lines)
    assert lines[-1].startswith("[stream] checkpoints durable")
    code, lines = _run(stream_cli.main, args + ["--restore", "--kill-after", "4"])
    assert code == 0 and "restored" in lines[0] and "at slide 4" in lines[0]


def test_launch_stream_serve_reports_the_writers_crash(tmp_path):
    args = ["--dataset", "T10I4D100K", "--min-sup", "0.05", "--block-txns", "128",
            "--n-blocks", "2", "--batches", "4", "--device", "cpu", "--serve",
            "--serve-queries", "20", "--kill-after", "2",
            "--checkpoint-dir", str(tmp_path)]
    code, lines = _run(stream_cli.main, args)
    assert code == 3
    assert any("injected crash mid-append at slide 2" in ln for ln in lines)

"""The port's static and steady-state gate over the mining path:

    python -m repro_torch.staticcheck                   # all three layers, on the card
    python -m repro_torch.staticcheck --device cpu      # the same on the host
    python -m repro_torch.staticcheck --lint-target F.. # lint files/dirs (exit 1 on findings)
    python -m repro_torch.staticcheck --contract-fixture extra_psum
    python -m repro_torch.staticcheck --shape-fixture

(with ``src`` on ``PYTHONPATH``).  The layers, as the reference's
``scripts/check_static.py`` runs its own:

  1. AST lint    RS001-RS005 strict over src/repro_torch, warn-only over
                 tests/test_torch_*.py; every RS005 suppression and sync
                 marker matched to ``shapes.SYNC_BUDGET``
  2. contracts   one expansion of every backend and a ring write on 4 gloo
                 ranks (sharing the card, or on the host): the declared
                 collective set, byte budget and reduce axis
  3. audit       a warm mine() level by level and >= 5 stream slides,
                 compact=True and compact=False, on the fused backend (on
                 the host: ref and fused): the declared host syncs exactly,
                 what the card synchronised on (the profiler's CUDA
                 runtime calls) within their total, no build and no new
                 allocator segment, every padding on the bucket ladder

The gate also self-tests its teeth: every must-fail fixture (the lint's,
the four contract programs, the shape fixture, the card-sync fixture)
must still produce its findings, or the gate fails.  It writes a JSON report (default
``reports/torch_static_findings.json``, git-ignored) and exits 1 on any
error finding; a ``--contract-fixture`` or ``--shape-fixture`` run exits 1
when it finds what it must.  Without ``--device cpu`` it runs on the card,
and raises on a host with none.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from . import Report, check_sync_markers, iter_python_files, lint_file, lint_paths, rule_ids

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
# each rule's must-fail fixture, the port's own copies (never a path of the
# reference's tree)
FIXTURES = {rid: os.path.join(os.path.dirname(__file__), "fixtures",
                              f"{rid.lower()}_bad.py")
            for rid in ("RS001", "RS002", "RS003", "RS004", "RS005")}
STRICT_DIRS = (os.path.join("src", "repro_torch"),)
DEFAULT_REPORT = os.path.join(ROOT, "reports", "torch_static_findings.json")


def _print(findings, label: str) -> None:
    for f in findings:
        print(f"static: [{label}] {f.format()}", file=sys.stderr)


def run_lint(report: Report) -> int:
    from .shapes import SYNC_BUDGET
    strict_files = iter_python_files(ROOT, STRICT_DIRS)
    strict = lint_paths(strict_files, root=ROOT)
    strict += check_sync_markers(strict_files, SYNC_BUDGET, root=ROOT)
    tests = sorted(p for p in iter_python_files(ROOT, ["tests"])
                   if os.path.basename(p).startswith("test_torch_"))
    warn = lint_paths(tests, root=ROOT, severity="warning")
    _print(strict, "lint")
    _print(warn, "lint/warn-only")
    report.extend(strict)
    report.extend(warn)
    print(f"static: lint strict={len(strict)} warn-only={len(warn)}")
    return len(strict)


def run_lint_fixtures(report: Report) -> int:
    """Every rule's must-fail fixture must still trip exactly that rule."""
    rotted = [rid for rid in rule_ids()
              if not any(f.rule == rid for f in lint_file(FIXTURES[rid], root=ROOT))]
    for rid in rotted:
        print(f"static: FIXTURE ROTTED — {os.path.relpath(FIXTURES[rid], ROOT)} "
              f"no longer triggers {rid}", file=sys.stderr)
    report.summary["lint_fixtures"] = {"checked": len(rule_ids()), "rotted": len(rotted)}
    print(f"static: lint fixtures {len(rule_ids()) - len(rotted)}/{len(rule_ids())} "
          f"still fail as committed")
    return len(rotted)


def run_contracts(report: Report, device: str) -> int:
    """Layer 2 and its four fixtures, in one start of the ranks."""
    from .contracts import CONTRACT_FIXTURES, check_all_contracts
    findings, summary = check_all_contracts(device, tuple(sorted(CONTRACT_FIXTURES)))
    _print(findings, "ir")
    report.extend(findings)
    for name, t in summary["targets"].items():
        print(f"static: contract {name}: rank 0 counted {t['counted_rank0']} over "
              f"groups {t['widths_rank0']}, declared {t['declared']}")
    rotted = [name for name, rules in summary["fixtures"].items() if not rules]
    for name, rules in summary["fixtures"].items():
        print(f"static: contract fixture {name} rejected by {rules}")
    for name in rotted:
        print(f"static: FIXTURE ROTTED — IR fixture {name!r} no longer violates "
              f"its contract", file=sys.stderr)
    report.summary["ir_contracts"] = summary
    print(f"static: contracts over {len(summary['targets'])} targets on "
          f"{summary['ranks']} gloo ranks ({device}), {len(findings)} finding(s); "
          f"IR fixtures {len(CONTRACT_FIXTURES) - len(rotted)}/{len(CONTRACT_FIXTURES)} "
          f"still fail as committed")
    return len(findings) + len(rotted)


def _print_syncs(summary: dict) -> None:
    """An audit's host syncs, declared and counted, per level and slide."""
    target, syncs = summary["target"], summary["syncs"]
    if isinstance(syncs, dict):                   # a mine: level by level
        for lv in syncs["per_level"]:
            print(f"static: {target} level {lv['level']}: declared syncs "
                  f"{lv['declared']} counted {lv['counted']}; the card "
                  f"synchronised {lv['card']}")
        out = syncs["outside_levels"]
        if out["declared"] is not None:
            print(f"static: {target} outside the levels: declared "
                  f"{out['declared']} counted {out['counted']}; the card "
                  f"synchronised {out['card']}")
        return
    for sl in syncs:                              # a stream: slide by slide
        per_level = sl["counted"]["per_level"]
        same = all(got == sl["declared"]["per_level"] for got in per_level)
        print(f"static: {target} slide {sl['slide']}: {sl['levels']} levels, "
              f"declared syncs a level {sl['declared']['per_level']}, counted "
              f"{'the same in each' if same else per_level}; outside the levels "
              f"declared {sl['declared']['outside_levels']} counted "
              f"{sl['counted']['outside_levels']}; the card synchronised "
              f"{_card_line(sl['card'])}")


def _card_line(card) -> str:
    """A slide's card count, its levels' totals folded when they agree."""
    if card is None:
        return "(not cut)"
    totals = {lv["total"] for lv in card["levels"]}
    per_level = (f"{totals.pop()} a level" if len(totals) == 1 else
                 f"{[lv['total'] for lv in card['levels']]} by level")
    return f"{per_level}, {card['outside']} outside them"


def run_shapes(report: Report, device: str) -> int:
    from .shapes import audit_mine, audit_streaming
    backends = ("fused",) if device == "cuda" else ("ref", "fused")
    n_findings, summaries = 0, []
    for backend in backends:
        for compact in (True, False):
            for audit in (audit_mine, audit_streaming):
                findings, summary = audit(backend, compact=compact, device=device)
                _print_syncs(summary)
                _print(findings, "shape")
                report.extend(findings)
                summaries.append(summary)
                n_findings += len(findings)
                what = (f"{summary['levels']} levels" if "levels" in summary
                        else f"{summary['audited_slides']} audited slides")
                print(f"static: audit {summary['target']} — {what}, "
                      f"{len(findings)} finding(s), allocator "
                      f"{summary['allocator']}; checked {summary['checks']}"
                      + (f"; not checked: {summary['not_checked']}"
                         if summary["not_checked"] else ""))
    report.summary["shape_audits"] = summaries
    return n_findings


def run_shape_fixture(report: Report, device: str) -> int:
    from .shapes import check_card_sync_fixture, check_shape_fixture
    rules = sorted({f.rule for f in check_shape_fixture(device)})
    want = {"SH001", "SH002", "SH003"} if device == "cuda" else {"SH003"}
    rotted = 0 if want <= set(rules) else 1
    if rotted:
        print(f"static: FIXTURE ROTTED — shape fixture only triggered {rules}, "
              f"expected {sorted(want)}", file=sys.stderr)
    report.summary["shape_fixture"] = {"rules": rules, "rotted": rotted}
    print(f"static: shape fixture trips {rules}")
    # the sync only the profiler sees: a card finding, no warn-mode sync
    findings, seen = check_card_sync_fixture(device)
    if device == "cuda":
        card_rotted = int(not findings or bool(seen["warn_mode"]))
        if card_rotted:
            print(f"static: FIXTURE ROTTED — card-sync fixture: profiler count "
                  f"{seen['card']}, warn mode {seen['warn_mode']} (expected a "
                  f"finding from the profiler alone)", file=sys.stderr)
        print(f"static: card-sync fixture trips {sorted({f.rule for f in findings})}"
              f" through the profiler's count {seen['card']}; the warn mode "
              f"counted {seen['warn_mode'] or '{}'}")
    else:
        card_rotted = int(bool(findings))
        print(f"static: card-sync fixture {seen['not_checked']}")
    report.summary["card_sync_fixture"] = {
        "rules": sorted({f.rule for f in findings}), "rotted": card_rotted,
        **{k: v for k, v in seen.items()}}
    return rotted + card_rotted


def full_gate(report_path: str, device: str) -> int:
    report = Report()
    bad = run_lint(report)
    bad += run_lint_fixtures(report)
    bad += run_contracts(report, device)
    bad += run_shapes(report, device)
    bad += run_shape_fixture(report, device)
    report.summary["violations"] = bad
    report.summary["device"] = device
    report.write(report_path)
    print(f"static: report -> {os.path.relpath(report_path, ROOT)}")
    if bad:
        print(f"static: {bad} violation(s)", file=sys.stderr)
        return 1
    print("static: OK")
    return 0


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where layers 2 and 3 run (default: the card)")
    ap.add_argument("--lint-target", nargs="+", metavar="PATH",
                    help="lint specific files/dirs; exit 1 on any finding")
    ap.add_argument("--contract-fixture", metavar="NAME",
                    help="run one contract fixture; exit 1 when it violates "
                         "its contract (the committed ones must)")
    ap.add_argument("--shape-fixture", action="store_true",
                    help="run the shape fixtures (the one of each rule, and "
                         "the sync only the profiler counts); exit 1 when they "
                         "produce findings (the committed ones must)")
    ap.add_argument("--report", default=DEFAULT_REPORT, metavar="PATH",
                    help="findings report path (default "
                         "reports/torch_static_findings.json)")
    args = ap.parse_args(argv)

    if args.lint_target:
        findings = []
        for target in args.lint_target:
            path = os.path.abspath(target)
            if os.path.isdir(path):
                findings.extend(lint_paths(
                    iter_python_files(ROOT, [os.path.relpath(path, ROOT)]), root=ROOT))
            else:
                findings.extend(lint_file(path, root=ROOT))
        _print(findings, "lint")
        print(f"static: {len(findings)} finding(s)")
        return 1 if findings else 0

    from ..device import resolve_device
    device = resolve_device(args.device).type      # None: the card, or raise

    if args.contract_fixture:
        from .contracts import check_contract_fixture
        findings = check_contract_fixture(args.contract_fixture, device)
        _print(findings, "ir")
        print(f"static: {len(findings)} finding(s)")
        return 1 if findings else 0

    if args.shape_fixture:
        from .shapes import check_card_sync_fixture, check_shape_fixture
        findings = check_shape_fixture(device) + check_card_sync_fixture(device)[0]
        _print(findings, "shape")
        print(f"static: {len(findings)} finding(s)")
        return 1 if findings else 0

    return full_gate(os.path.abspath(args.report), device)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The reference package's Layer-1 AST lint (``repro.staticcheck.astlint``)
over every module of the port: the rules the JAX package holds its own
code to (no bare ``assert`` guarding a runtime invariant, no ``np.empty``
index buffer without a justified suppression, ...) hold for the port too.
Only the tests import both packages."""
import glob
import os

from repro.staticcheck.astlint import lint_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


FIXTURES = os.path.join(ROOT, "src", "repro_torch", "staticcheck", "fixtures")


def _all_port_files():
    return sorted(glob.glob(os.path.join(ROOT, "src", "repro_torch", "**", "*.py"),
                            recursive=True))


def _port_files():
    """Every module of the port: all its files but the port's guard's
    must-fail lint fixtures (never imported), which the reference's own
    ``iter_python_files`` skips as it skips its own."""
    return [f for f in _all_port_files()
            if os.path.dirname(f) != FIXTURES]


def test_the_port_has_modules_to_lint():
    files = _port_files()
    assert len(files) > 90
    assert any(f.endswith(os.path.join("core", "engine.py")) for f in files)


def test_the_reference_lint_finds_nothing_in_the_port():
    findings = lint_paths(_port_files(), root=ROOT)
    assert findings == [], "\n".join(
        f"{f.rule} {f.path}:{f.line}: {f.message}" for f in findings)
    # what is left out is the guard's fixtures alone, and the reference's
    # lint finds in each of RS001-RS004's the rule it plants (RS005's is
    # the port's torch rule, which the reference's RS005 does not read)
    left_out = sorted(set(_all_port_files()) - set(_port_files()))
    assert [os.path.basename(f) for f in left_out] == [
        f"rs00{i}_bad.py" for i in range(1, 6)]
    for f in left_out[:4]:
        rid = os.path.basename(f)[:5].upper()
        assert {x.rule for x in lint_paths([f], root=ROOT)} == {rid}, f

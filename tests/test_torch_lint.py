"""The reference package's Layer-1 AST lint (``repro.staticcheck.astlint``)
over every module of the port: the rules the JAX package holds its own
code to (no bare ``assert`` guarding a runtime invariant, no ``np.empty``
index buffer without a justified suppression, ...) hold for the port too.
Only the tests import both packages."""
import glob
import os

from repro.staticcheck.astlint import lint_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    return sorted(glob.glob(os.path.join(ROOT, "src", "repro_torch", "**", "*.py"),
                            recursive=True))


def test_the_port_has_modules_to_lint():
    files = _port_files()
    assert len(files) > 90
    assert any(f.endswith(os.path.join("core", "engine.py")) for f in files)


def test_the_reference_lint_finds_nothing_in_the_port():
    findings = lint_paths(_port_files(), root=ROOT)
    assert findings == [], "\n".join(
        f"{f.rule} {f.path}:{f.line}: {f.message}" for f in findings)

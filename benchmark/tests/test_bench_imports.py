"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the port, and a CPU dry run of a cell loads
none of them."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import FORBIDDEN
from benchmark.tests.tiny import REPO

BENCH = REPO / "benchmark"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = set(_imports(f)) & set(FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for f in (BENCH / "reference").rglob("*.py"):
        assert "dyffusion_tpu_torch" not in set(_imports(f)), f
        assert set(_imports(f)) <= {"__future__", "math", "dataclasses", "typing", "numpy", "torch", "benchmark"}, f


def test_a_dry_run_loads_no_jax():
    code = ("import sys, tempfile; from pathlib import Path; sys.path.insert(0, '.');"
            "from benchmark.tests.tiny import tiny_root; from benchmark import harness;"
            "t = tempfile.mkdtemp(); r = harness.execute('tiny-serve', 1, 0.2, 0, device='cpu', root=tiny_root(Path(t)));"
            "print(r['correct'], harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"

"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references and the input generators import nothing of the program.
Top-level names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}
INDEPENDENT = ("reference", "traffic")       # nor the program


def _top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


def test_the_walk_finds_the_harness():
    names = {p.relative_to(BENCH).as_posix() for p in MODULES}
    assert {"run.py", "reference/lm.py", "reference/mlp.py",
            "traffic/cohort.py", "drivers/lm_fedstep.py"} <= names


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(BENCH).as_posix()
                              for p in MODULES])
def test_imports(path):
    names = set(_top_names(path))
    assert not names & NEVER, f"{path} imports {sorted(names & NEVER)}"
    if path.relative_to(BENCH).parts[0] in INDEPENDENT:
        assert "repro_torch" not in names, f"{path} imports the program"


def test_the_rule_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom reprox import y\n")
    assert not set(_top_names(f)) & NEVER
    f.write_text("from repro.core import scbf\n")
    assert set(_top_names(f)) & NEVER == {"repro"}

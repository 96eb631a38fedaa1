"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``."""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
KERNELS = ("channel_norm", "select_mask", "select_compact", "apoz")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_port_has_files():
    """Every TPU kernel has its CUDA source, and the build compiles all of
    them and only them."""
    from repro_torch.kernels import build
    assert len(FILES) > 15
    assert sorted(p.stem for p in CSRC.glob("*.cu")) == sorted(KERNELS)
    assert sorted(build.SOURCES) == sorted(KERNELS)
    assert sorted(build.SIGNATURES) == sorted(KERNELS)


@pytest.mark.parametrize("name", KERNELS)
def test_cuda_sources_are_plain_c_without_torch_or_jax(name):
    """Each kernel source includes only CUDA headers (the build binds it
    with ctypes, no PyTorch headers) and names the TPU kernel it
    replaces."""
    text = (CSRC / f"{name}.cu").read_text()
    includes = [l.split()[1] for l in text.splitlines()
                if l.startswith("#include")]
    assert includes and all(i.startswith("<cuda") for i in includes), \
        includes
    assert "torch" not in text.lower().replace("pytorch", "") and \
        "jax" not in text
    assert "Replaces the TPU kernel repro/kernels/" in text
    assert 'extern "C" int' in text


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_check_tells_the_packages_apart():
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device the smoke run exits non-zero and prints no
    result line — here and when it stands alone in a directory."""
    import subprocess
    import sys

    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout

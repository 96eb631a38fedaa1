"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py``, an ``examples/torch_*.py`` example or a
``benchmarks/torch_*.py`` script imports JAX, the reference package
``repro`` or a benchmark module of the reference (``benchmarks.common``
imports JAX)."""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"] + \
    sorted((REPO / "examples").glob("torch_*.py")) + \
    sorted((REPO / "benchmarks").glob("torch_*.py"))
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
# the TPU kernels' ports, each naming the kernel it replaces
TPU_PORTS = ("channel_norm", "select_mask", "select_compact", "apoz")
# the port's own kernels, which replace no TPU kernel
OWN = ("sum_sgd",)
KERNELS = TPU_PORTS + OWN


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    if top == "benchmarks":
        # only the port's own scripts: ``benchmarks.common`` and the
        # reference's benchmarks import JAX
        return not name.split(".")[-1].startswith("torch_")
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_port_has_files():
    """Every TPU kernel has its CUDA source, as has each of the port's own
    kernels, and the build compiles all of them and only them."""
    from repro_torch.kernels import build
    assert len(FILES) > 15
    assert sorted(p.stem for p in CSRC.glob("*.cu")) == sorted(KERNELS)
    assert sorted(build.SOURCES) == sorted(KERNELS)
    assert sorted(build.SIGNATURES) == sorted(KERNELS)


def _plain_c(name: str) -> str:
    """The source's text, after checking that it includes only CUDA
    headers (the build binds it with ctypes, no PyTorch headers), names
    neither torch nor JAX and exports C launchers."""
    text = (CSRC / f"{name}.cu").read_text()
    includes = [l.split()[1] for l in text.splitlines()
                if l.startswith("#include")]
    assert includes and all(i.startswith("<cuda") for i in includes), \
        includes
    assert "torch" not in text.lower().replace("pytorch", "") and \
        "jax" not in text
    assert 'extern "C" int' in text
    return text


@pytest.mark.parametrize("name", TPU_PORTS)
def test_cuda_sources_are_plain_c_without_torch_or_jax(name):
    """Each TPU kernel's port is plain C with CUDA headers only and names
    the TPU kernel it replaces."""
    text = _plain_c(name)
    assert "Replaces the TPU kernel repro/kernels/" in text
    assert "Replaces no TPU kernel" not in text


@pytest.mark.parametrize("name", OWN)
def test_the_ports_own_kernels_are_plain_c_and_replace_no_tpu_kernel(name):
    """Each of the port's own kernels is plain C with CUDA headers only and
    says that it replaces no TPU kernel."""
    text = _plain_c(name)
    assert "Replaces no TPU kernel" in text
    assert "Replaces the TPU kernel" not in text


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_check_tells_the_packages_apart():
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert _forbidden("benchmarks.common")
    assert _forbidden("benchmarks.fig2_scbf_vs_fa")
    assert not _forbidden("repro_torch.core")
    assert not _forbidden("benchmarks.torch_fig2_scbf_vs_fa")
    assert any(p.name == "torch_table_time.py" for p in FILES)


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

"""tracelint over the port (``repro_torch.analysis``): captured CUDA
graphs, host syncs, rebuilt programs and the kernels' C signatures.

(a) Engine parity: the port's ``astgraph`` under the reference's JAX
dialect builds the reference's call graph on the reference's fixtures —
every function's in-trace mark, resolved calls and static parameters,
every module's jitted symbols and JAX import flag.  (b) The torch
translation of every reference bad fixture fires its rule as many times
as the original (TL005: a ``SIGNATURES`` entry one argument short of its
``.cu`` prototype, and one passing an int for a pointer), the good
fixtures are clean, and capture reachability follows the port's own
``RoundProgram``, ``BatchedEngine._program`` and the replay loop.  (c) The port linted
once gives exactly ``analysis/torch_baseline.json``; its real
``kernels/build.SIGNATURES`` match ``kernels/csrc``, and a copy with one
argtype dropped is a TL005.
"""
import os
import pathlib
import shutil
import subprocess
import sys
from collections import Counter

import pytest

from _torch_lint import jax_dialect
from repro_torch.analysis import astgraph, rules, tracelint
from repro_torch.analysis.report import Baseline

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_tracelint"
REF_FIXTURES = REPO / "tests" / "fixtures"

BAD_EXPECT = {
    "tl001_graph_per_call.py": {"TL001": 1},     # a graph captured per call
    "tl001_library_per_call.py": {"TL001": 1},   # a library loaded per call
    "tl002_host_sync.py": {"TL002": 3},
    "tl003_tensor_branch.py": {"TL003": 2},
    "tl004_varying_shapes.py": {"TL004": 2},
    "tl005_signatures.py": {"TL005": 2},         # one short + int for ptr
    "tl006_host_loop_transfers.py": {"TL006": 3},
}


@pytest.fixture(scope="module")
def port():
    old = os.getcwd()
    os.chdir(REPO)
    try:
        paths = tracelint.expand_paths(["src/repro_torch",
                                        "benchmarks/torch_*.py"])
        findings, files = tracelint.run_paths(paths)
        return findings, files, astgraph.build_graph(paths)
    finally:
        os.chdir(old)


def _graph_facts(mods, funcs, ref: bool):
    m = {name: (sorted(mod.jitted_symbols if ref else mod.program_symbols),
                mod.imports_jax if ref else mod.imports_backend,
                sorted(mod.imports.items()), sorted(mod.classes))
         for name, mod in mods.items()}
    f = {key: (fn.in_trace, sorted(fn.calls), sorted(fn.static_params),
               fn.params, fn.parent, fn.decorators)
         for key, fn in funcs.items()}
    return m, f


@pytest.mark.parametrize("tool", ["tracelint", "privlint", "shapelint"])
@pytest.mark.parametrize("part", ["bad", "good"])
def test_call_graph_matches_the_reference(tool, part):
    from repro.analysis import astgraph as ref_graph
    paths, roots = [str(REF_FIXTURES / tool / part)], \
        [str(REF_FIXTURES / tool)]
    want = ref_graph.build_graph(paths, roots)
    got = astgraph.build_graph(paths, roots, dialect=jax_dialect())
    assert _graph_facts(got.modules, got.functions, False) == \
        _graph_facts(want.modules, want.functions, True)
    if tool == "tracelint" and part == "bad":
        assert any(fn.in_trace for fn in want.functions.values())


@pytest.fixture(scope="module")
def bad_findings():
    return tracelint.run_paths([str(FIXTURES / "bad")],
                               source_roots=[str(FIXTURES)])[0]


@pytest.mark.parametrize("name", sorted(BAD_EXPECT))
def test_bad_fixture_fires_its_rule(bad_findings, name):
    got = Counter(f.rule for f in bad_findings
                  if pathlib.Path(f.path).name == name)
    assert got == Counter(BAD_EXPECT[name]), dict(got)


def test_bad_fixtures_cover_every_rule(bad_findings):
    assert {f.rule for f in bad_findings} == set(rules.ALL_RULES)
    tl005 = sorted(f.message for f in bad_findings if f.rule == "TL005")
    assert "takes 5 argument(s)" in tl005[0] and "give 4" in tl005[0]
    assert "argument 2 is pointer" in tl005[1] and "but int" in tl005[1]


def test_good_fixtures_are_clean():
    findings, files = tracelint.run_paths([str(FIXTURES / "good")],
                                          source_roots=[str(FIXTURES)])
    assert files == 4
    assert findings == [], [f.render() for f in findings]


def test_capture_reachability_follows_the_round_programs(port):
    """``RoundProgram.__init__`` captures its ``fn``; ``_program`` passes
    its ``fn`` on, so it captures it too, and the one replay loop
    (``_replay_rounds``) passes its methods' train and server halves on;
    the one-graph round (``_fused_round``), both methods' halves, the
    gather, the slot pass and local training under them are in-trace;
    the host loops (``run_federated``, ``_replay_rounds``) are not."""
    _, _, graph = port
    assert graph.capturers == {
        "repro_torch.fed.graphs:RoundProgram.__init__": {"fn"},
        "repro_torch.fed.engine:BatchedEngine._program": {"fn"},
        "repro_torch.fed.engine:BatchedEngine._replay_rounds": {"train",
                                                               "server"}}
    marked = {k for k, fn in graph.functions.items() if fn.in_trace}
    for key in ("fed.engine:_fused_round", "fed.engine:_fused_scbf_train",
                "fed.engine:_fused_scbf_server",
                "fed.engine:_fused_fedavg_train",
                "fed.engine:_fused_fedavg_server", "fed.engine:_gather_slots",
                "comm.collectives:gather_slots",
                "fed.engine:_slot_pass", "core.client:local_train_slots",
                "core.selection:select_gradients",
                "kernels.channel_norm:channel_norms_leaves",
                "fed.strategy:scbf_sum_step", "fed.strategy:fedavg_step"):
        assert f"repro_torch.{key}" in marked, key
    for key in ("core.scbf:run_federated", "fed.engine:BatchedEngine"
                ".scbf_round", "fed.engine:BatchedEngine._replay_rounds",
                "fed.graphs:RoundProgram.__call__"):
        assert f"repro_torch.{key}" not in marked, key


def test_the_port_gives_exactly_its_baseline(port):
    findings, files, _ = port
    bl = Baseline.load(str(REPO / "analysis" / "torch_baseline.json"))
    assert files > 80
    assert {f.key for f in findings} == set(bl.entries)
    assert not any(f.rule == "TL005" for f in findings)
    for key, rec in bl.entries.items():
        just = rec.get("justification", "")
        assert just and "TODO" not in just, key


def test_a_launcher_one_argument_short_is_tl005(tmp_path):
    """The port's own ``SIGNATURES`` against its ``csrc``: clean; with
    ``select_mask_launch``'s ``counts`` argtype dropped, a TL005 naming
    the five-argument prototype."""
    kernels = tmp_path / "kernels"
    shutil.copytree(REPO / "src" / "repro_torch" / "kernels", kernels,
                    ignore=shutil.ignore_patterns("__pycache__"))
    build = kernels / "build.py"
    clean, _ = tracelint.run_paths([str(build)], rules=["TL005"])
    assert clean == []
    text = build.read_text()
    entry = '"select_mask_launch": ([_VOID, _INT, _INT, _VOID, _VOID], _INT)'
    assert text.count(entry) == 1
    build.write_text(text.replace(
        entry, '"select_mask_launch": ([_VOID, _INT, _INT, _VOID], _INT)'))
    got, _ = tracelint.run_paths([str(build)], rules=["TL005"])
    assert [(f.rule, f.symbol) for f in got] == [("TL005", "<module>")]
    assert "'select_mask_launch' takes 5 argument(s)" in got[0].message


def test_cli_gate(tmp_path):
    tree = tmp_path / "pkg"
    tree.mkdir()
    shutil.copy(FIXTURES / "good" / "host_loop_idioms.py", tree)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.tracelint",
             str(tree), *args], env=env, cwd=tmp_path, capture_output=True,
            text=True, timeout=120)
    assert run("--baseline", "").returncode == 0
    shutil.copy(FIXTURES / "bad" / "tl001_graph_per_call.py", tree)
    out = run("--baseline", "")
    assert out.returncode == 1 and "TL001" in out.stdout
    assert run("--baseline", "", "--rules", "TL999").returncode == 2

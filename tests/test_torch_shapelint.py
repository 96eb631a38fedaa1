"""shapelint over the port (``repro_torch.analysis``): padding provenance,
dtype drift and masks, read in torch terms.

(a) Engine parity: the port's ``astgraph`` and ``shapes``, given the
reference's policy, wrapper names and words (and JAX's idiom: ``axis=``
only, no positional axes or size lists), return exactly the reference
linter's findings on the reference's fixtures.  (b) A torch translation
of every reference bad fixture fires its rule as many times as the
original (the port's padders ``slots.slot_chunked`` and
``fed/engine._train_slots`` as the producers) and the good fixtures are
clean; torch's idiom (``dim=``, a positional dim, ``.to(dtype)``,
``.float()``, ``clamp_min``) reads as the reference's.  (c) The port
linted once as a whole gives exactly the findings of
``analysis/torch_shape_baseline.json``, each justified.
"""
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
from collections import Counter

import pytest

from _torch_lint import jax_calls, jax_dialect
from repro_torch.analysis import astgraph, shapelint, shaperules, shapes
from repro_torch.analysis.report import Baseline

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_shapelint"
REF_FIXTURES = REPO / "tests" / "fixtures" / "shapelint"

BAD_EXPECT = {
    "sl001_padded_sum.py": {"SL001": 1},        # slot_chunked, no mask
    "sl002_mean_over_bucket.py": {"SL002": 2},  # mean + Σvalid denom
    "sl003_f64_drift.py": {"SL003": 2},         # np.float64 + .double()
    "sl004_bool_arith.py": {"SL004": 2},        # sum(valid) + x * valid
    "sl005_broadcast.py": {"SL005": 1},         # padded rank 2 × rank 1
    "sl006_unguarded_div.py": {"SL006": 2},     # unguarded Σvalid + log
    "sl001_interproc.py": {},                   # lands in the helper
    "reduce_helper.py": {"SL001": 1},           # ...which is here
}


def _jax_policy():
    """The port's ShapePolicy with the reference's tables, wrappers,
    words and JAX's idiom: the engine as the reference's."""
    from repro.analysis import shaperules as ref_rules
    tables = {f.name: getattr(ref_rules.POLICY, f.name)
              for f in dataclasses.fields(ref_rules.POLICY)}
    return shapes.ShapePolicy(
        **tables, axis_keywords=("axis", "dims"), positional_axis=False,
        varargs_shapes=False, call_sites=False, calls=jax_calls(),
        words={"reach": "jit-reachable",
               "f64": "under JAX's default x64 setting this silently "
                      "truncates (or, with x64 enabled, doubles "
                      "memory/retraces)",
               "cast": ".astype(...)", "cast_int": ".astype(jnp.int32)",
               "where": "jnp.where(valid, x, 0)",
               "guard_eps": "jnp.maximum(x, eps)",
               "guard_one": "jnp.maximum(x, 1)"})


def _facts(findings):
    return sorted((f.rule, f.path, f.line, f.col, f.symbol, f.message)
                  for f in findings)


@pytest.fixture(scope="module")
def port():
    old = os.getcwd()
    os.chdir(REPO)
    try:
        return shapelint.run_paths(["src/repro_torch",
                                    "benchmarks/torch_*.py"])
    finally:
        os.chdir(old)


@pytest.mark.parametrize("part", ["bad", "good"])
def test_engine_matches_the_reference_on_its_fixtures(part):
    from repro.analysis import astgraph as ref_graph
    from repro.analysis import shaperules as ref_rules
    paths, roots = [str(REF_FIXTURES / part)], [str(REF_FIXTURES)]
    want = ref_rules.run_shape_rules(ref_graph.build_graph(paths, roots))
    graph = astgraph.build_graph(paths, roots, dialect=jax_dialect())
    got = shapes.ShapeAnalysis(graph, _jax_policy()).run()
    assert _facts(got) == _facts(want)
    assert (part == "bad") == bool(want)


@pytest.fixture(scope="module")
def bad_findings():
    return shapelint.run_paths([str(FIXTURES / "bad")],
                               source_roots=[str(FIXTURES)])[0]


@pytest.mark.parametrize("name", sorted(BAD_EXPECT))
def test_bad_fixture_fires_its_rule(bad_findings, name):
    got = Counter(f.rule for f in bad_findings
                  if pathlib.Path(f.path).name == name)
    assert got == Counter(BAD_EXPECT[name]), dict(got)


def test_bad_fixtures_cover_every_rule(bad_findings):
    assert {f.rule for f in bad_findings} == set(shaperules.SHAPE_RULES)


def test_good_fixtures_are_clean():
    findings, files = shapelint.run_paths([str(FIXTURES / "good")],
                                          source_roots=[str(FIXTURES)])
    assert files == 2
    assert findings == [], [f.render() for f in findings]


def test_provenance_crosses_modules():
    helper = str(FIXTURES / "bad" / "reduce_helper.py")
    alone, _ = shapelint.run_paths([helper], source_roots=[str(FIXTURES)])
    assert alone == []
    pair, _ = shapelint.run_paths(
        [helper, str(FIXTURES / "bad" / "sl001_interproc.py")],
        source_roots=[str(FIXTURES)])
    assert [(pathlib.Path(f.path).name, f.rule, f.symbol) for f in pair] \
        == [("reduce_helper.py", "SL001", "total")]


def test_torch_idiom_reads_as_the_references(tmp_path):
    """A reduction names its slot axis with ``dim=`` or a positional dim
    (``torch.sum(x, 0)``, ``x.sum(0)``); ``.to(torch.int32)`` and
    ``.float()`` are casts; ``x.clamp_min(1)`` is a positive guard.
    The same code with the axis left out, the bool summed raw and the
    guard dropped fires SL001, SL004 and SL006."""
    (tmp_path / "good.py").write_text(textwrap.dedent("""
        import torch
        from repro_torch.slots import slot_chunked

        def per_slot(x, w):
            p = slot_chunked(torch.mul, x, w)
            return torch.sum(p, dim=1) + torch.sum(p, 1) + p.sum(1)

        def tally(valid, total):
            n = valid.to(torch.int32).sum() + valid.float().sum()
            return total / torch.sum(valid.float()).clamp_min(1.0) + n
    """))
    (tmp_path / "bad.py").write_text(textwrap.dedent("""
        import torch
        from repro_torch.slots import slot_chunked

        def per_slot(x, w):
            p = slot_chunked(torch.mul, x, w)
            return p.sum()

        def tally(valid, total):
            n = valid.sum()
            return total / torch.sum(valid.float())
    """))
    good, _ = shapelint.run_paths([str(tmp_path / "good.py")])
    assert good == [], [f.render() for f in good]
    bad, _ = shapelint.run_paths([str(tmp_path / "bad.py")])
    assert sorted(f.rule for f in bad) == ["SL001", "SL004", "SL006"]


def test_the_port_gives_exactly_its_baseline(port):
    findings, files = port
    bl = Baseline.load(str(REPO / "analysis" / "torch_shape_baseline.json"))
    assert files > 80
    assert {f.key for f in findings} == set(bl.entries)
    for key, rec in bl.entries.items():
        just = rec.get("justification", "")
        assert just and "TODO" not in just, key


def test_cli_gate(tmp_path):
    tree = tmp_path / "pkg"
    tree.mkdir()
    shutil.copy(FIXTURES / "good" / "masked_reduction.py", tree)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.shapelint",
             str(tree), *args], env=env, cwd=tmp_path, capture_output=True,
            text=True, timeout=120)
    assert run("--baseline", "").returncode == 0
    shutil.copy(FIXTURES / "bad" / "sl001_padded_sum.py", tree)
    out = run("--baseline", "")
    assert out.returncode == 1 and "SL001" in out.stdout
    out = run("--baseline", "", "--rules", "SL004")
    assert out.returncode == 0

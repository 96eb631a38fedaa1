"""privlint over the port (``repro_torch.analysis``): the taint gate of the
client→server privacy boundary, read in torch terms.

(a) Engine parity: the port's ``astgraph`` and ``taint``, given the
reference's policy, wrapper names and words, return exactly the
reference linter's findings on the reference's fixtures (rule, file,
line, column, symbol, message).  (b) A torch translation of every
reference bad fixture fires its rule as many times as the original, a
torch-only re-seeded generator fires PL003, and the good fixtures are
clean.  (c) The port linted as a whole gives exactly the findings of
``analysis/torch_privacy_baseline.json``, each justified, the
counterparts of the reference's three PL006 aggregation points among
them.  (d) On a copy of the port with the selection removed from the
slot pass, the dense delta reaching ``wire.encode_round`` is a PL001:
the lint covers the upload path the port really ships.  The port is
linted once for the module.
"""
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
from collections import Counter

import pytest

from _torch_lint import jax_calls, jax_dialect
from repro_torch.analysis import astgraph, privlint, privrules, taint
from repro_torch.analysis.report import (Baseline, assign_ordinals,
                                         decorator_regions, suppressed)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_privlint"
REF_FIXTURES = REPO / "tests" / "fixtures" / "privlint"
PORT_PATHS = ["src/repro_torch", "benchmarks/torch_*.py"]

# filename -> exactly which rules fire, and how often (the reference's
# counts on the JAX originals; pl003_reseed is the torch-only case)
BAD_EXPECT = {
    "pl001_dense_delta.py": {"PL001": 1},
    "pl002_noise_after_encode.py": {"PL002": 1},
    "pl003_key_reuse.py": {"PL003": 2},     # loop-invariant + double use
    "pl003_padded_slots.py": {"PL003": 1},  # slot 0's normals padded out
    "pl003_reseed.py": {"PL003": 1},        # loop-invariant re-seed
    "pl004_unaccounted.py": {"PL004": 2},   # unaccounted + double-count
    "pl005_mask_widen.py": {"PL005": 2},    # widen + compacted geometry
    "pl006_loss_event.py": {"PL006": 1},
    "pl001_interproc.py": {},               # finding lands in the helper
    "leak_helper.py": {"PL001": 1},         # ...which is here
}


def _jax_policy():
    """The port's Policy with the reference's tables, call wrappers,
    noise argument and message words: the engine as the reference's."""
    from repro.analysis import privrules as ref_rules
    tables = {f.name: getattr(ref_rules.POLICY, f.name)
              for f in dataclasses.fields(ref_rules.POLICY)}
    return taint.Policy(
        **tables, noise_arg="key", call_sites=False, calls=jax_calls(),
        words={"key": "PRNG key", "fresh": "split a fresh key per release",
               "derive": "derive distinct keys",
               "filler": "use distinct derived keys for filler slots"})


def _facts(findings):
    return sorted((f.rule, f.path, f.line, f.col, f.symbol, f.message)
                  for f in findings)


@pytest.fixture(scope="module")
def port():
    """The port linted once: (raw findings before suppression comments,
    the gate's findings, files scanned), paths relative to the repo."""
    old = os.getcwd()
    os.chdir(REPO)
    try:
        graph = astgraph.build_graph(privlint.expand_paths(PORT_PATHS))
        raw = privrules.run_privacy_rules(graph)
        regions = {m.path: (decorator_regions(m.tree), m.source_lines)
                   for m in graph.modules.values()}
        kept = [f for f in raw
                if not suppressed(f, regions[f.path][1], regions[f.path][0])]
        return raw, assign_ordinals(kept), len(graph.modules)
    finally:
        os.chdir(old)


# ---------------------------------------------------------------------------
# (a) engine parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["bad", "good"])
def test_engine_matches_the_reference_on_its_fixtures(part):
    from repro.analysis import astgraph as ref_graph
    from repro.analysis import privrules as ref_rules
    paths, roots = [str(REF_FIXTURES / part)], [str(REF_FIXTURES)]
    want = ref_rules.run_privacy_rules(ref_graph.build_graph(paths, roots))
    graph = astgraph.build_graph(paths, roots, dialect=jax_dialect())
    got = taint.TaintAnalysis(graph, _jax_policy()).run()
    assert _facts(got) == _facts(want)
    assert (part == "bad") == bool(want)


# ---------------------------------------------------------------------------
# (b) the torch fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bad_findings():
    return privlint.run_paths([str(FIXTURES / "bad")],
                              source_roots=[str(FIXTURES)])[0]


@pytest.mark.parametrize("name", sorted(BAD_EXPECT))
def test_bad_fixture_fires_its_rule(bad_findings, name):
    got = Counter(f.rule for f in bad_findings
                  if pathlib.Path(f.path).name == name)
    assert got == Counter(BAD_EXPECT[name]), dict(got)


def test_bad_fixtures_cover_every_rule(bad_findings):
    assert {f.rule for f in bad_findings} == set(privrules.PRIV_RULES)
    assert {pathlib.Path(f.path).name for f in bad_findings} == \
        {n for n, e in BAD_EXPECT.items() if e}


def test_good_fixtures_are_clean():
    findings, files = privlint.run_paths([str(FIXTURES / "good")],
                                         source_roots=[str(FIXTURES)])
    assert files == 3
    assert findings == [], [f.render() for f in findings]


def test_taint_crosses_modules():
    """The helper that encodes its argument is clean alone; with the
    caller that feeds it a dense delta the PL001 lands inside it."""
    helper = str(FIXTURES / "bad" / "leak_helper.py")
    alone, _ = privlint.run_paths([helper], source_roots=[str(FIXTURES)])
    assert alone == []
    pair, _ = privlint.run_paths(
        [helper, str(FIXTURES / "bad" / "pl001_interproc.py")],
        source_roots=[str(FIXTURES)])
    assert [(pathlib.Path(f.path).name, f.rule, f.symbol) for f in pair] \
        == [("leak_helper.py", "PL001", "ship_update")]


def test_generators_are_keys_and_index_draws_are_not(tmp_path):
    """``torch.Generator``/``manual_seed`` and the normals drawn on one
    are the noise's randomness (one slot's normals expanded over the
    slots is PL003); a permutation drawn on a generator is not."""
    (tmp_path / "m.py").write_text(textwrap.dedent("""
        import torch
        from repro_torch.core import privacy

        def spread(real, seed, slots):
            gen = torch.Generator().manual_seed(seed)
            z = privacy.draw_normals(real, gen)[0]
            return z.expand(slots, *z.shape)

        def perms(n, seed, slots):
            gen = torch.Generator().manual_seed(seed)
            p = torch.randperm(n, generator=gen)
            return p.expand(slots, n)
    """))
    found, _ = privlint.run_paths([str(tmp_path)])
    assert [(f.rule, f.symbol) for f in found] == [("PL003", "spread")]


# ---------------------------------------------------------------------------
# (c) the port against its baseline
# ---------------------------------------------------------------------------

def test_the_port_gives_exactly_its_baseline(port):
    _, findings, files = port
    bl = Baseline.load(str(REPO / "analysis" / "torch_privacy_baseline.json"))
    assert files > 80
    assert {f.key for f in findings} == set(bl.entries)
    for key, rec in bl.entries.items():
        just = rec.get("justification", "")
        assert just and "TODO" not in just and "repro_torch" in \
            rec["file"], key


def test_the_reference_pl006_sites_have_counterparts(port):
    """The reference baselines three PL006 aggregation points (the slot
    pass's ``slot_metrics`` and two ``FedAvgMetrics`` sites).  The port's
    lint finds all three: the batched ``fedavg_round`` and the fused
    FedAvg round's server step are in the baseline; the slot pass's is
    found and suppressed in source, where the reference's own lint of
    the port needs the comment."""
    raw, findings, _ = port
    sites = {(pathlib.Path(f.path).name, f.symbol) for f in raw
             if f.rule == "PL006"}
    assert {("engine.py", "_slot_pass"),
            ("engine.py", "BatchedEngine.fedavg_round"),
            ("engine.py", "BatchedEngine.fused_fedavg_chunk.server")} \
        <= sites
    assert "slot_metrics" in next(
        f.message for f in raw if f.symbol == "_slot_pass")
    assert not any(f.symbol == "_slot_pass" for f in findings)


# ---------------------------------------------------------------------------
# (d) the real upload path is covered
# ---------------------------------------------------------------------------

_SELECTION = """    masked, masks, _, _ = sel.select_gradients(
        g, cfg.upload_rate, cfg.selection, score_norm=cfg.score_norm,
        sample_idx=sample_idx, generator=generator, neuron_masks=nmasks)
"""


def test_a_dense_delta_on_encode_round_is_pl001(tmp_path, port):
    """Remove the channel selection from the slot pass in a copy of the
    port: the dense delta then reaches ``wire.encode_round`` through
    ``BatchedEngine._emit``, where the unmutated port has no finding."""
    _, findings, _ = port
    assert not any(f.rule == "PL001" and "_emit" in f.symbol
                   for f in findings)
    copy = tmp_path / "src" / "repro_torch"
    shutil.copytree(REPO / "src" / "repro_torch", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    engine = copy / "fed" / "engine.py"
    text = engine.read_text()
    assert text.count(_SELECTION) == 1
    engine.write_text(text.replace(
        _SELECTION, "    masked, masks = g, g\n"))
    got, _ = privlint.run_paths([str(engine)])
    hits = [f for f in got if f.rule == "PL001" and
            f.symbol == "BatchedEngine._emit"]
    assert len(hits) == 1
    assert "wire.encode_round" in engine.read_text().splitlines()[
        hits[0].line - 1]
    assert "client_delta()" in hits[0].message


# ---------------------------------------------------------------------------
# the CLIs: exit codes, baselines, the merged runner
# ---------------------------------------------------------------------------

_PL001 = textwrap.dedent("""
    from repro_torch.comm import wire
    from repro_torch.core.client import client_delta, local_train_slots

    def leak(params, x, y, lr, perms, ops, num):
        new_p = local_train_slots(tuple(params), x, y, lr, perms)
        delta = client_delta(tuple(params), new_p)
        return wire.encode_round(tuple(delta), ops, num){suffix}
""")


def _run_cli(module, args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_suppression_and_keys(tmp_path):
    (tmp_path / "noisy.py").write_text(_PL001.format(suffix=""))
    (tmp_path / "quiet.py").write_text(
        _PL001.format(suffix="  # privlint: disable=PL001"))
    (tmp_path / "wrong.py").write_text(
        _PL001.format(suffix="  # privlint: disable=PL004"))
    found, _ = privlint.run_paths([str(tmp_path)])
    assert sorted(pathlib.Path(f.path).name for f in found) == \
        ["noisy.py", "wrong.py"]
    shifted = tmp_path / "shift"
    shifted.mkdir()
    (shifted / "noisy.py").write_text("# header\n\n" +
                                      _PL001.format(suffix=""))
    moved, _ = privlint.run_paths([str(shifted / "noisy.py")])
    assert moved[0].key.split(":")[2:] == found[0].key.split(":")[2:]
    assert moved[0].line == found[0].line + 2


def test_cli_gate_and_baseline(tmp_path):
    tree = tmp_path / "pkg"
    tree.mkdir()
    shutil.copy(FIXTURES / "good" / "good_sanctioned_chain.py", tree)
    out = _run_cli("repro_torch.analysis.privlint",
                   [str(tree), "--baseline", ""], tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    (tree / "regress.py").write_text(_PL001.format(suffix=""))
    out = _run_cli("repro_torch.analysis.privlint",
                   [str(tree), "--baseline", ""], tmp_path)
    assert out.returncode == 1 and "regress.py" in out.stdout
    bl = tmp_path / "bl.json"
    out = _run_cli("repro_torch.analysis.privlint",
                   [str(tree), "--baseline", str(bl), "--write-baseline"],
                   tmp_path)
    assert out.returncode == 0
    assert _run_cli("repro_torch.analysis.privlint",
                    [str(tree), "--baseline", str(bl)],
                    tmp_path).returncode == 0
    out = _run_cli("repro_torch.analysis.privlint",
                   [str(tree), "--rules", "PL999"], tmp_path)
    assert out.returncode == 2


def test_merged_runner(tmp_path):
    """``python -m repro_torch.analysis``: one report, one exit code,
    ``--json-out``, ``--rules`` routed to the tools that own them,
    ``--write-baseline`` into each tool's baseline."""
    tree = tmp_path / "pkg"
    tree.mkdir()
    (tree / "regress.py").write_text(_PL001.format(suffix=""))
    none = ["--trace-baseline", "", "--privacy-baseline", "",
            "--shape-baseline", ""]
    out = _run_cli("repro_torch.analysis",
                   [str(tree), *none, "--json-out", "-"], tmp_path)
    assert out.returncode == 1
    head, _, tail = out.stdout.partition("\n}\n")
    data = json.loads(head + "\n}")
    assert set(data["tools"]) == {"tracelint", "privlint", "shapelint"}
    assert [f["rule"] for f in data["tools"]["privlint"]["new"]] == \
        ["PL001"]
    assert "tracelint:" in tail and "shapelint:" in tail
    out = _run_cli("repro_torch.analysis",
                   [str(tree), *none, "--rules", "TL001,SL001"], tmp_path)
    assert out.returncode == 0 and "privlint:" not in out.stdout
    bls = [str(tmp_path / f"{t}.json") for t in ("t", "p", "s")]
    out = _run_cli("repro_torch.analysis",
                   [str(tree), "--trace-baseline", bls[0],
                    "--privacy-baseline", bls[1], "--shape-baseline", bls[2],
                    "--write-baseline"], tmp_path)
    assert out.returncode == 0
    out = _run_cli("repro_torch.analysis",
                   [str(tree), "--trace-baseline", bls[0],
                    "--privacy-baseline", bls[1], "--shape-baseline",
                    bls[2]], tmp_path)
    assert out.returncode == 0, out.stdout

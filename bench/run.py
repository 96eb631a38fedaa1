"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  A run sets up its cell (imports, the
kernel libraries, inputs and weights from the seed, a warm-up of the
cell's own shapes), measures ``--seconds`` of steady work, and prints as
the last line of its standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
and, traced, ``breakdown``; then the numbers compared with the plain
reference, each beside its limit, under ``checks``.

Every part of a cell is found by name (``harness/registry.py``): a later
change adds a cell, configuration, traffic mix or per-layer metric by
adding files and entries to ``BENCHMARK.json``.  The run exits non-zero
and prints no result when the card is missing or the cell asks for more
cards than there are, when anything fails, and when JAX or the JAX
package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _prepare(bench: Path) -> None:
    """The program's sources and the harness on the path; every build and
    kernel cache at a fixed place inside the checkout."""
    root = bench.parent
    for p in (str(bench), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run(args, bench: Path = BENCH, device: str = "cuda",
        t_start: float = T_START, preloaded=()) -> dict:
    """One run of a cell; returns the result object (or raises).
    ``preloaded``: forbidden modules the process held before the run (a
    test process's, none in the command's), which the run did not load."""
    _prepare(bench)
    from harness import registry
    cell = registry.find_cell(args.workload, bench)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"cell {cell.name} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} found")
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    drv = cell.driver().Driver(cell, args.seed, device, _log)
    split = drv.setup(t_start)
    setup_s = time.perf_counter() - t_start
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips}
    breakdown = None
    if args.trace == 0:
        res = drv.window(args.seconds)
        values = dict(res["metrics"], setup_s=setup_s)
        wanted = cell.end_to_end
        attempted, failed = res["attempted"], res["failed"]
    else:
        ctx = drv.traced()
        w = ctx["window"]
        ctx.update(kind=kind, cell=cell.name)
        values = {}
        for m in cell.per_layer:
            v = cell.layer_reader(m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = v
        wanted = [m for m in cell.per_layer if m["name"] in values]
        attempted, failed = ctx.get("attempted", 1), 0
        device_info.update(busy_s=w.busy_s(), window_s=w.window_s)
        breakdown = w.breakdown()
        _log("traced window: " + json.dumps(w.info))
    metrics = {}
    for m in wanted:
        if m["name"] not in values:
            raise RuntimeError(f"cell {cell.name} reports no {m['name']}")
        metrics[m["name"]] = {"value": float(values[m["name"]]),
                              "unit": m["unit"]}
    if device == "cuda":
        torch.cuda.synchronize()
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    else:
        device_info["memory_peak_bytes"] = 0
    found = sorted(set(forbidden_modules()) - set(preloaded))
    if found:
        raise SystemExit(f"loaded after the window: {found}")
    drv.release()
    readings = drv.check()
    limits = cell.spec.get("limits", {})
    checks, correct = {}, failed == 0
    for name, value in readings.items():
        limit = limits.get(name)
        ok = _finite(value) and limit is not None and value <= limit
        correct = correct and ok
        checks[name] = {"value": float(value), "limit": limit}
    if set(limits) - set(readings):
        correct = False
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_split_s"] = split
    out["checks"] = checks
    found = sorted(set(forbidden_modules()) - set(preloaded))
    if found:
        raise SystemExit(f"loaded: {found}")
    _log("setup split (s): " + json.dumps(split))
    for name, c in checks.items():
        _log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    return out


def main(argv=None) -> int:
    args = parse(argv)
    # one process with few threads (set before torch and numpy load): host
    # thread pools add jitter to a window whose pace the host sets
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    try:
        out = run(args)
    except SystemExit as e:
        _log(f"bench: {e}")
        return 3
    except BaseException:
        traceback.print_exc()
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

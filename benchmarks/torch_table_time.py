"""Paper §3 time claims on the PyTorch/CUDA port: pruning saves ~57% of
SCBF's wall time (~48% for FedAvg) at ≤ 0.0047 / 0.0068 less AUC-ROC /
AUC-PR (the counterpart of ``benchmarks/table_time.py``).

Runs ``torch_fig2_scbf_vs_fa.run`` (the four methods) and prints, per
method, the total loop wall (``LoopRecord.wall_time``: the round span,
synchronised with the device, evaluation excluded), the FLOPs proxy
(params × examples summed over loops), the best and final AUC-ROC and
AUC-PR and the upload MB; then, for SCBFwP against SCBF and FAwP against
FedAvg, the wall and FLOPs saved and the best-AUC deltas.  The card's
name and power limit come first.

    PYTHONPATH=src python benchmarks/torch_table_time.py --full

``--full`` is the paper's setting (30 loops at 30,760 × 2,917, MLP
2917-256-64-1) and writes the Fig. 2 summary to
``experiments/torch_fig2_summary_h100.json`` (``--out``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks.torch_fig2_scbf_vs_fa import DEFAULT_OUT  # noqa: E402
from benchmarks.torch_fig2_scbf_vs_fa import run as run_fig2  # noqa: E402


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--loops", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help=f"summary JSON (--full default: {DEFAULT_OUT})")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        print(f"card: {card()}")
    out = args.out or (DEFAULT_OUT if args.full else None)
    results, _ = run_fig2(quick=not args.full, loops=args.loops, out=out,
                          device=args.device)

    def totals(m):
        res = results[m]
        return res.total_time(), sum(r.flops_proxy for r in res.records)

    print("method,wall_s,flops_proxy,auc_roc_best,auc_pr_best,"
          "auc_roc_final,auc_pr_final,upload_mb")
    for m, res in results.items():
        wall, flops = totals(m)
        print(f"{m},{wall!r},{flops:.6e},{res.best('auc_roc')!r},"
              f"{res.best('auc_pr')!r},{res.final.auc_roc!r},"
              f"{res.final.auc_pr!r},{res.total_upload_bytes() / 1e6!r}")
    for base in ("scbf", "fedavg"):
        wp = base + "wp"
        if base in results and wp in results:
            w0, f0 = totals(base)
            w1, f1 = totals(wp)
            droc = results[base].best("auc_roc") - results[wp].best("auc_roc")
            dpr = results[base].best("auc_pr") - results[wp].best("auc_pr")
            print(f"{wp} vs {base}: wall saved {100 * (1 - w1 / w0):.2f}% "
                  f"flops saved {100 * (1 - f1 / f0):.2f}% "
                  f"d_auc_roc {droc:+.4f} d_auc_pr {dpr:+.4f}")
    if out:
        print(f"summary: {out}")


if __name__ == "__main__":
    main()

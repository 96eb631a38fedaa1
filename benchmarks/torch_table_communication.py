"""Paper §3 communication claims on the PyTorch/CUDA port, measured on the
real wire formats (the counterpart of ``benchmarks/table_communication.py``).

  * SCBF positive selection at α=10% uploads ~45% of parameters
    (the channel-union effect);
  * dense vs encoded upload bytes — the bytes are the actual
    ``repro_torch.comm.wire`` payload sizes (cheapest of coo / bitmap /
    dense per layer), so "sparse" never exceeds dense.

One client's upload at α ∈ {0.05, 0.10, 0.25, 0.50, 0.90} with positive
selection and at 0.10 with negative selection: the port's ``init_mlp``,
``core.selection.select_gradients`` (the channel-norm and select-mask
kernels on the card) and the encode of the selected delta
(``comm.wire.encode_selected``: the select-compact kernel on the card),
field for field ``wire.encode`` of the masked delta.  The gradients are
normals × 0.01 drawn from a ``torch.Generator`` seeded with ``seed``;
``grads`` (and ``sample_idx``, for the sampled quantile) take the
reference's draws instead.

    PYTHONPATH=src python benchmarks/torch_table_communication.py [--full]

The quick setting is MLP 400-64-16-1, ``--full`` the paper's
2917-256-64-1; ``--device`` defaults to cuda.
"""
from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.comm import wire  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.mlp_net import init_mlp  # noqa: E402

RATES = (0.05, 0.10, 0.25, 0.50, 0.90)
QUICK, FULL = (400, 64, 16, 1), (2917, 256, 64, 1)


def measure_upload(rate: float, feats=FULL, selection_mode: str = "positive",
                   seed: int = 0, device=None, grads=None, sample_idx=None):
    """One client's upload at rate α: (param_fraction, encoded_bytes,
    dense_bytes, per-codec layer counts)."""
    dev = resolve_device(device)
    params = init_mlp(feats, torch.Generator().manual_seed(seed), device=dev)
    if grads is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        grads = tuple({k: torch.randn(v.shape, generator=gen, device=dev)
                       * 0.01 for k, v in layer.items()} for layer in params)
    masked, masks, _, ops = selection.select_gradients(
        list(grads), rate, selection_mode, sample_idx=sample_idx)
    st = selection.UploadStats.from_masks(masks)
    payload = wire.encode_selected(masked, ops)
    codecs = Counter(lp.codec for lp in payload.layers)
    return st.upload_fraction, payload.nbytes, payload.dense_nbytes, codecs


def run(quick: bool = True, device=None):
    """The table's rows: (selection, rate, fraction, encoded bytes, dense
    bytes, codecs)."""
    feats = QUICK if quick else FULL
    rows = []
    for rate in RATES:
        frac, enc, dense, codecs = measure_upload(rate, feats, device=device)
        rows.append(("positive", rate, frac, enc, dense, codecs))
    frac, enc, dense, codecs = measure_upload(0.10, feats, "negative",
                                              device=device)
    rows.append(("negative", 0.10, frac, enc, dense, codecs))
    return rows


def csv_lines(rows):
    """The reference's CSV: a header and a line a row."""
    out = ["selection,rate,param_fraction_uploaded,encoded_bytes,"
           "dense_bytes,saving,codecs"]
    for mode, rate, frac, enc, dense, codecs in rows:
        saving = 1.0 - enc / max(dense, 1)
        cd = "+".join(f"{v}x{k}" for k, v in sorted(codecs.items()))
        out.append(f"{mode},{rate},{frac:.4f},{enc},{dense},{saving:.2%},"
                   f"{cd}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rows = run(quick=not args.full, device=args.device)
    for line in csv_lines(rows):
        print(line)
    print("\nencoded bytes are measured repro_torch.comm.wire payloads "
          "(cheapest codec per layer; never exceeds dense)")
    print("paper claim: positive selection at alpha=0.10 uploads ~45% "
          "of parameters")
    return rows


if __name__ == "__main__":
    main()

"""``python -m repro_torch.analysis`` — the port's merged tracelint +
privlint + shapelint runner.

Use ``python -m repro_torch.analysis.tracelint`` / ``.privlint`` for a single
tool with its full CLI (baseline writing, rule subsets, …).
"""
import sys

from repro_torch.analysis.runner import main

sys.exit(main())

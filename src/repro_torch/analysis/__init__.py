"""The port's static analysis: tracelint, privlint and shapelint over
``repro_torch`` (the counterpart of ``repro.analysis``).

* ``astgraph``  — module parsing + the capture-reachability call graph
  (which functions end up *inside* a captured CUDA graph), under a
  :class:`~repro_torch.analysis.astgraph.Dialect`.
* ``taint`` / ``privrules`` / ``privlint`` — the client→server privacy
  boundary (PL001–PL006).
* ``shapes`` / ``shaperules`` / ``shapelint`` — padding provenance,
  dtype drift and masks (SL001–SL006).
* ``rules`` / ``tracelint`` — captures, host syncs, rebuilt programs and
  the kernels' C signatures (TL001–TL006).
* ``report``    — findings, suppression comments, baseline files,
  human/JSON rendering.
* ``config``    — rule registry and file discovery.
* ``runner``    — ``python -m repro_torch.analysis``, all three at once.

Every reference rule keeps its code and meaning, read in torch terms;
none is dropped.  TL005, the reference's ``pallas_call`` BlockSpec
contract, has no BlockSpec to check in the port, whose kernels are
CUDA C++ behind ``ctypes``: its torch counterpart checks each
launcher's ``argtypes`` in ``kernels/build.SIGNATURES`` against the
``extern "C"`` prototype in ``kernels/csrc/*.cu``, the contract whose
breach is garbage on the card that no CPU test sees.  The reference's
``static_argnames`` (a jit's static arguments) have no counterpart: a
CUDA graph takes no static arguments, so only the scalar-annotated and
keyword-only convention marks a parameter static.

Deliberately import-free: ``python -m repro_torch.analysis.tracelint``
must not find the submodule pre-imported in ``sys.modules`` (runpy
warns), and the package imports neither torch nor anything it scans.
"""

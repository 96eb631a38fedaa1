"""The reference's JAX vocabulary for the port's analysis engines: with
it, ``repro_torch.analysis``'s call graph, taint and shape engines are
the reference's (the parity tests hold them to it)."""
from repro_torch.analysis import astgraph, taint


def jax_dialect() -> astgraph.Dialect:
    """The reference's trace roots: jit and its traced wrappers."""
    from repro.analysis import astgraph as ref_graph
    return astgraph.Dialect(
        tracing_wrappers=frozenset(ref_graph._TRACING_WRAPPERS),
        program_makers=frozenset(ref_graph._JIT_NAMES), backend="jax")


def jax_calls() -> taint.Calls:
    """The reference's call wrappers (vmap, jit, partial, …) and scans."""
    from repro.analysis import taint as ref_taint
    return taint.Calls(curried=tuple(ref_taint._CALL_WRAPPERS),
                       scans=tuple(ref_taint._SCAN_NAMES))

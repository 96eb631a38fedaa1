"""BAD (TL005): launcher signatures that disagree with their CUDA
prototypes (``csrc/counts.cu``) — one entry is an argument short of
its prototype, the other passes an int where the prototype takes a
pointer.  ctypes converts by ``argtypes`` alone, so both launch with
garbage arguments on the card, which no CPU test sees."""
import ctypes

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong

SIGNATURES = {
    "counts": {
        # rows, L, counts, stream: one short of the prototype's n
        "counts_launch": ([_VOID, _INT, _VOID, _VOID], _INT),
        # rows, L, n, stream: `out` is a pointer in the prototype
        "scatter_launch": ([_VOID, _INT, _INT, _LL, _VOID], _INT),
    },
}

"""GOOD: launcher signatures that match their CUDA prototypes
(``csrc/counts.cu``) by count and by kind.  Zero findings."""
import ctypes

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong

SIGNATURES = {
    "counts": {
        # rows, L, n, counts, stream
        "counts_launch": ([_VOID, _INT, _LL, _VOID, _VOID], _INT),
        # rows, L, recip, stream
        "scale_launch": ([_VOID, _INT, ctypes.c_float, _VOID], _INT),
    },
}

"""gemm_ms.mlp: device ms a loop in matrix-product kernels (cuBLAS and
CUTLASS names), from the profiler's trace of an experiment's steady loops: the
local SGD of ``core/client.local_train_slots`` in the replays, and the
evaluations."""


def read(ctx):
    loops = ctx["loops"]
    return 1e3 * ctx["window"].gemm_s() / loops

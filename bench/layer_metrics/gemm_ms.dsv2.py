"""gemm_ms.dsv2: device ms a traced step in matrix-product kernels
(cuBLAS and CUTLASS names, ``trace.Window.gemm_s``): the model's
products, forward, backward and remat's recompute, and the window's
opening burst's three 1,024-square products."""


def read(ctx):
    return 1e3 * ctx["window"].gemm_s() / ctx["steps"]

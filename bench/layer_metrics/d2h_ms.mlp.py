"""d2h_ms.mlp: device ms a loop of device-to-host copies (the emission's
uploads, the evaluations' scores), from the profiler's trace of an
experiment's steady loops."""


def read(ctx):
    loops = ctx["loops"]
    return 1e3 * ctx["window"].time_of("DtoH")[1] / loops

"""setup_s: from the start of the clock (after the mesh file is written) to
the first measured step: imports, CUDA context, kernel builds or their
cache, mesh, plan, preconditioner, captures and the warm-up steps."""


def read(ctx):
    return ctx["setup_s"]

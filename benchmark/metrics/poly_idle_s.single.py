"""Device-idle seconds a proof of the profiled call while the innermost
span open on the host is one of the program's polynomial spans
(`sonic.poly.*`: the builds, the products, the divisions) or the s(X, y)
build it spans at the call site. With a mesh, rank 0's."""
from benchmark import program

HOOKS = program.PROVE


def read(run):
    return program.idle_s(run, HOOKS, "sonic.poly.", program.POLY_LABELS)

"""Device-idle seconds a proof of the profiled call while the innermost
span open on the host is one of the program's commitment and MSM spans
(`sonic.msm.*`: digits and layout, plans, bucket sums, weighted sums,
the window combine). With a mesh, rank 0's."""
from benchmark import program

HOOKS = program.PROVE


def read(run):
    return program.idle_s(run, HOOKS, "sonic.msm.")

"""Seconds from the process's start to the window's first call: CUDA
start-up, the kernels loaded from the build directory, SRS.new on the
device, the circuits and the witness pool made and uploaded, one warm-up
call of each kind."""


def read(run):
    return run.setup_s

"""Set-up: from the process's start to the start of the window (the build
or the load of the kernels and the warm-up included; host clock)."""


def read(run):
    return run["setup_s"]

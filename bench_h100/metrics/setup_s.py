"""Set-up time: from the process's start until the window opens (imports,
CUDA initialisation, the pool, the pipeline, the weights and the warm-up
or the first updates, with the graph's capture). A checkout's first run
also builds the kernels with nvcc."""

UNIT = "s"


def read(r):
    return r.setup_s

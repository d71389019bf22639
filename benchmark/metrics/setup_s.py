"""s: from the process's start to the first timed request: imports, the
CUDA context, loading (and, in a fresh checkout, building) the kernels,
loading and preparing the scene, and the warm-up of the cell's shapes."""


def read(record):
    return record.setup_s

"""Process start to the first timed call: imports, CUDA initialisation, the
kernel library's load or build, the engine and its warm-up (host clock)."""


def read(run):
    return run.setup_s

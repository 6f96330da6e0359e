"""Process start to the window's first timed call (s): imports, CUDA,
kernel build or load, X, staging, warm-up."""


def read(rec):
    return rec["setup_s"]

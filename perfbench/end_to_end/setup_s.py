"""setup_s: from the process's start to the window's opening (loading,
making the weights, building or loading the kernels, warming up)."""


def read(record):
    return record["setup_s"]

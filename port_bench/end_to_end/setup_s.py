"""Process start to the first timed request or step: imports, the kernels'
build or load, weights, the pool of inputs and the warm-up."""


def read(window):
    return window["setup_s"]

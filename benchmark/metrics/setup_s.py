"""Seconds from the start of the process to the window: imports, the kernels'
build or load, the data, the model, the warm start, the warm-up and the
restart that sizes the window."""


def read(run):
    return run.spans["setup_s"]

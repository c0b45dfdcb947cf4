"""Seconds from the process's start to the first timed statement: imports,
the kernels' build (only the first run in a checkout compiles), the
tables' generation, loading and staging, and the warm-up."""


def read(run):
    return run.setup_s

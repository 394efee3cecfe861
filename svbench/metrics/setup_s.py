"""Seconds from the process's first line to the window: imports, CUDA
and kernel loading, the genome cache (built on a checkout's first run),
the samples' generation, the region references and the warm-up."""


def read(record):
    return record["setup_s"]

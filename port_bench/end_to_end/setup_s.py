"""Seconds from the process's start to the window's start: imports, weights,
traffic, the model's preparation, graph captures and warm-up (and, on a
checkout's first run, the kernel's build)."""


def read(rec, ctx):
    return rec.setup_s

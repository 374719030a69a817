"""Seconds from the process's start to the first timed gate: imports,
kernel build or load, the key material, the program's key (bake and
relayout, or the MK expansion), the operand pool and one warm unit."""


def read(run):
    return run.setup_s

"""The card's peak of allocated memory over set-up and the window
(`torch.cuda.max_memory_allocated`), read before the reference runs: the
room one tenant's key and traffic take."""


def read(run):
    return run.mem_peak_bytes / 2**30 if run.mem_peak_bytes else None

"""The cloud key the program holds on the card: the bytes (`numel` times
the element size) of its bootstrap key and keyswitch table(s)."""


def read(run):
    return run.key_bytes / 2**30

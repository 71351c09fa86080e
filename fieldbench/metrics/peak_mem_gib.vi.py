"""The allocator's peak over the window, less the benchmark's record of
the checked step, in GiB."""


def read(s):
    return s["peak_bytes"] / 2**30 if s["peak_bytes"] else None

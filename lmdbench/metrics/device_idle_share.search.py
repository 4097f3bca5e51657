"""device_idle_share.search: the card. 100 minus the share of the traced
segment in which a kernel, copy or fill ran on it, in %."""

from lmdbench import readers


def read(run):
    return readers.idle_share(run)

"""sort_gkeys_per_s (Gkeys/s, host clock): the keys sorted by the
requests that completed in the window, over the window's seconds, /1e9."""

from sortbench.harness.readers import rate


def read(record):
    value = rate(record, lambda r: r.work)
    return None if value is None else value / 1e9

"""setup_s (s, host clock): from the process's start to the first request
of the window: import, loading (or, in a checkout's first run, building)
the kernels, the data made on the device, and one call of each request
kind."""


def read(record):
    return record.setup_s

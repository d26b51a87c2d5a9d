"""peak_device_gib (GiB): ``torch.cuda.max_memory_allocated()`` over
set-up and window, after ``reset_peak_memory_stats()`` at the process's
start; read before the reference runs.  The reading is the CUDA
caching allocator's own peak of the device's memory, which the harness
takes itself, not a counter of the program's; of the two sources an
end-to-end metric may name, ``device_trace`` is the nearer."""


def read(record):
    if record.peak_bytes is None:
        return None
    return record.peak_bytes / 2**30

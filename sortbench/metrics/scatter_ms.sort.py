"""Device ms a sort in the payload carry, torch's operators between the
kernels (the rank's widening to int64, the zero fill, the index write,
the MSD pass's trailing mask): the summed ``device_s`` of the port's
``executor.scatter`` spans over its ``sort.call`` spans
(``repro_torch.obs.trace``; collected for a few requests after the
traced window)."""

from sortbench.harness.spans import ms_a_call


def read(record):
    return ms_a_call(record, "executor.scatter", "device_s")

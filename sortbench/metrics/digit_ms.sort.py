"""Device ms a sort in digit extraction, ``(u >> shift) & mask``: the
summed ``device_s`` of the port's ``executor.digit`` spans over its
``sort.call`` spans (``repro_torch.obs.trace``; collected for a few
requests after the traced window)."""

from sortbench.harness.spans import ms_a_call


def read(record):
    return ms_a_call(record, "executor.digit", "device_s")

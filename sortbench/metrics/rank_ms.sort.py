"""Device ms a sort in the rank calls, K2 or K3 with the bin-start scan:
the summed ``device_s`` of the port's ``executor.rank`` spans over its
``sort.call`` spans (``repro_torch.obs.trace``; collected for a few
requests after the traced window)."""

from sortbench.harness.spans import ms_a_call


def read(record):
    return ms_a_call(record, "executor.rank", "device_s")

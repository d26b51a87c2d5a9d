"""Device ms a request in the K1 sweep, every digit's histogram from one
read of the keys before the pass loop: the traced window's device
seconds of the port's ``histogram_digits_kernel`` (torch.profiler's
device timeline, the kernel alone, no launch gap) over its completed
requests.  None for a run with no device trace, and where the kernel is
not among the window's operations of most time."""

from sortbench.harness.readers import per_request

KERNEL = "histogram_digits_kernel"


def read(record):
    tr = record.trace
    if tr is None:
        return None
    seconds = dict(tr.device_ops).get(KERNEL)
    if seconds is None:
        return None
    return per_request(record, lambda _: seconds)

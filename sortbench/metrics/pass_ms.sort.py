"""pass_ms.sort (ms): the summed wall of the port's ``executor.pass``
spans a sort (``repro_torch.obs.trace``, collected for a few requests
after the traced window). Each span ends in a device synchronisation,
so it covers the pass's device work, and the sync itself perturbs."""

from sortbench.harness.readers import pass_ms as read  # noqa: F401

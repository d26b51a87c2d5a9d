"""Host ms a sort in plan resolution (``_resolve_plan``: the autotune
cache's consult, else the static plan): the summed wall of the port's
``sort.plan`` spans over its ``sort.call`` spans
(``repro_torch.obs.trace``; collected for a few requests after the
traced window)."""

from sortbench.harness.spans import ms_a_call


def read(record):
    return ms_a_call(record, "sort.plan", "wall_s")

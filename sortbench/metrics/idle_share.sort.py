"""The share of the traced window in which no operation ran on the
device (torch.profiler's device timeline), in %."""

from sortbench.harness.readers import idle_pct as read  # noqa: F401

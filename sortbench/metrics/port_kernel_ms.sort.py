"""Device ms a request in the port's own kernels K1-K5
(``kernels/csrc/*.cu``, launched through ``kernels/ops.py``'s wrappers):
the profiler's device kernels defined in the sources' anonymous
namespace, whose count is held to the wrappers' launch counters."""

from sortbench.harness.readers import port_kernel_ms as read  # noqa: F401

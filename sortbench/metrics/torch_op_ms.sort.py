"""Device ms a request in everything but the port's kernels: torch's
operators between them (digit extraction, the payload scatter, index
copies), copies and memsets."""

from sortbench.harness.readers import torch_op_ms as read  # noqa: F401

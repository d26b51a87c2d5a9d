"""FractalSort on PyTorch and CUDA: the port of the ``repro`` JAX package.

The in-memory sort of p-bit integer keys (p <= 32) runs through the same
plan/executor structure as the reference: :mod:`repro_torch.core` holds
the planner, the pass loop and the public sorts, and
:mod:`repro_torch.kernels` the hand-written Hopper (sm_90a) kernels for
histogram, rank and Algorithm-5 reconstruct, each beside its plain
PyTorch version.

Keys travel as int32 storage holding the uint32 bit pattern (torch's
``uint32`` has no shifts or compares on the CPU); p = 32 results are
returned as a ``uint32`` view.

Entry points run on the card unless the caller passes ``device="cpu"``.
Nothing here imports ``jax`` or the reference package.
"""

__all__ = ["core", "kernels", "obs"]

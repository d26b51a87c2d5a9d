"""The plain reference that decides ``correct``: plain PyTorch only.

It imports nothing of ``repro_torch`` and takes nothing the program has
made; it recomputes every answer from the inputs the benchmark made and
reads the program's outputs only to judge them.  A ``dtype`` or ``bits``
argument gives the control: the same computation in the nearest lower
precision, which must come out as not correct."""

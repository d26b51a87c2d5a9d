"""sort_roofline (%): the least time of a sort (each input key read once
and each output key or int32 permutation entry written once, 2 * n * 4
bytes, at the H100's published 3.35 TB/s) over the device-busy time a
sort in the traced window."""

from sortbench.harness.readers import sort_roofline_pct as read  # noqa: F401

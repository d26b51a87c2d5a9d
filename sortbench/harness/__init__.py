"""The general part of the benchmark: the manifest and its lookups by
name, the closed request loop, the reduction of the profiler's trace, and
the comparison that decides ``correct``."""

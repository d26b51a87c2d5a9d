"""Hand-written Hopper kernels (CUDA C++ for sm_90a, ``csrc/``) with
their wrappers, plain PyTorch versions (``ref``) and public entry points
(``ops``).  Sources build at the first CUDA use (``_build``), never at
import."""

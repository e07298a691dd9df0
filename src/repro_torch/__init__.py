"""PyTorch / CUDA port of the WLSH multi-weight ANN serving stack.

A second package beside the JAX reference (``repro``): the same planner
(numpy), the same serving plan, and the synchronous query path on one
device, with the two fused query passes as CUDA C++ kernels for Hopper
(``kernels/csrc/fused_query.cu``).  It imports torch and numpy only.
"""

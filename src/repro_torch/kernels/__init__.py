"""Query-step kernels of the PyTorch port: CUDA C++ for Hopper (sm_90a)
plus the plain torch version of each, and the per-device dispatch.

Float32 matrix products the port makes outside the kernels run in full
float32: TF32 is switched off here (``allow_tf32 = False``, matmul
precision ``"highest"``), because the good-level ceil flips at level
boundaries and a flipped good level can move a query's stop level.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

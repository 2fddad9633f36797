"""The plain reference: dense sums and solves in plain torch, the frozen
data generator and the frozen bound arithmetic of the near-field kernels.

Nothing here imports the port (``ferreus_rbf_tpu_torch``) or JAX; the
benchmark hands both sides the same inputs, and the reference reads the
port's outputs only to judge them.
"""

import torch

# true f32 products for the f32 control (f64 products never use TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

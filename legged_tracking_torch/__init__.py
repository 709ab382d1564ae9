"""PyTorch/CUDA port of ``legged_tracking_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names
and subpackages so that every function has a counterpart a reader can find.
It imports ``torch`` and ``numpy`` only, never JAX or the JAX package.

Physics runs in full float32 on the card, as the JAX engine asks for with
``jax.default_matmul_precision("float32")`` (``physics/engine.py``): TF32 is
switched off here, at import, for matrix products and for cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

"""Tensor ops of the port: codecs, the hand-written CUDA kernels with their
plain versions (q40: K1, K1m, K1d, K3, K3b; attention: K2, K5, K4, K4b;
paged_attention: K6, K7; layer: K8, K9, K10), and the dense glue around
them."""

import torch

# Dense f32 products (the plain versions, F32/F16 weights) run in full f32
# on the card — PyTorch's default, pinned here because the parity contract
# with the JAX reference depends on it (TF32 keeps ~3 decimal digits).
torch.backends.cuda.matmul.allow_tf32 = False

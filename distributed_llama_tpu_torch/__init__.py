"""distributed_llama_tpu_torch — the PyTorch/CUDA port of the JAX package.

Same `.bin` model and `tokenizer.bin` formats, same token streams, for one
NVIDIA H100. Plain tensor code is PyTorch; every kernel that the JAX package
wrote in Pallas is a CUDA C++ kernel written by hand for Hopper
(``csrc/*.cu``, built with nvcc on first use by ``ops/_build.py``).

The package imports torch, numpy and the standard library only — never jax,
and nothing of the JAX package; it keeps its own copies of what it needs. Its layout mirrors the JAX package module for module:

  ops.quants      block codecs (numpy) + torch Q40 dequant
  ops.q40         Q40 matvec / GEMM (f32, bf16): CUDA kernels + plain versions
  ops.attention   flash decode / prefill attention: CUDA kernels + plain versions
  ops.linear      rmsnorm / silu / matmul dispatch / load-time Q40 fusion
  models          spec, synthetic params, the Llama forward
  io              .bin loader/writer, tokenizer
  runtime         sampler, Engine + generation loop
  frontend.cli    the ``inference`` command
"""

__version__ = "0.1.0"

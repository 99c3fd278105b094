"""PyTorch/CUDA port of simple_tensorflow_tpu: paged causal-LM serving and
causal-LM training on an NVIDIA H100 with hand-written CUDA kernels (see
PERF.md)."""

"""PyTorch/CUDA port of kuiperllama_tpu: Llama-family INT8 inference on an
NVIDIA H100, with hand-written CUDA kernels (csrc/) for the group-dequant
INT8 matmuls. Imports torch and numpy only; kernels build on first use."""

"""CUDA kernel build and binding (nvcc + ctypes, no PyTorch headers)."""

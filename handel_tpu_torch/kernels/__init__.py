"""Hand-written CUDA kernels: the nvcc build and the ctypes bindings."""

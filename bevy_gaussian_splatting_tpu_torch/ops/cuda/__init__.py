"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

Each kernel's wrapper launches it for CUDA tensors and runs its plain PyTorch
version for CPU tensors; a CUDA tensor never falls back to the plain version.
"""

"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Dispatch follows the device of the inputs (``common.on_cuda``): CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
"""

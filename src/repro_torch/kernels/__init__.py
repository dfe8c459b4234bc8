"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Dispatch follows the device of the inputs (``common.on_cuda``): CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
"""
import torch

# torch's CPU exp, log and their kin call MKL's vector math (VML), which
# sets itself up at its first call.  When two intra-op threads make that
# first call at once (a process's first exp over more than one thread's
# share of elements, as the plain attention's), one of them can return its
# share up to 1e-4 off under a loaded host; later calls are exact.  One
# call here, on the importing thread, sets VML up before any parallel use.
torch.exp(torch.zeros(1))

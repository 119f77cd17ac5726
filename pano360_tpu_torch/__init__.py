"""pano360-tpu-torch: the panorama stitcher on PyTorch and CUDA.

A port of ``pano360_tpu`` (JAX/XLA/Pallas) to PyTorch, for one NVIDIA
H100. Module names mirror the JAX package so each counterpart is easy to
find; public functions keep the JAX layouts ((N, H, W[, C]) images,
(N, 3, 3) cameras) so the two packages can be held against each other
on the same inputs. The JAX package's Pallas kernels are CUDA kernels
here (``csrc/``): the SIFT octave stack, and the backward warp as an
exact kernel and a mip-sampled one (``--warp pallas``), each with a
plain PyTorch version beside it (``ops/gauss_octave.py``,
``ops/warp_kernel.py``, ``ops/warp_mip.py``).

Precision policy: float32 on the device, with TF32 off for matrix
products and convolutions (the JAX code pins HIGHEST precision in its
geometry, matching and warp math).
"""
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """The entry points' device: ``cuda`` unless one is named.

    Raises when CUDA is asked for and absent; the CPU runs only when it
    is named explicitly (the plain PyTorch versions of the kernels).
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' explicitly")
    return dev

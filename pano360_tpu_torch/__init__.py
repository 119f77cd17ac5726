"""pano360-tpu-torch: the panorama stitcher on PyTorch and CUDA.

A port of ``pano360_tpu`` (JAX/XLA/Pallas) to PyTorch, for one NVIDIA
H100. Module names mirror the JAX package so each counterpart is easy to
find; public functions keep the JAX layouts ((N, H, W[, C]) images,
(N, 3, 3) cameras) so the two packages can be held against each other
on the same inputs. Eight CUDA kernels, written by hand and built from
``csrc/`` at first use, each with a plain PyTorch version beside it that
the CPU runs and the card is held to bit for bit:

- the JAX package's two Pallas kernels: the SIFT octave stack
  (``gauss_octave.cu``; plain ``ops/gauss_octave.octave_stack_ref``) and
  the backward warp, exact (``backward_warp.cu``;
  ``ops/warp_kernel.backward_warp_ref``) and mip-sampled for ``--warp
  pallas`` (``backward_warp_mip.cu``;
  ``ops/warp_mip.backward_warp_mip_ref``);
- XLA's fusions of SIFT's front end (``ops/sift_front.py``): the base
  image, upsampled and blurred (``sift_base.cu``; plain
  ``ops/sift_front.base_image_ref``), and the small octaves' per-layer
  chain, DoG and score (``sift_small_octave.cu``;
  ``features/sift._gaussian_stack`` and ``gauss_octave._extrema_score``);
- XLA's fusions of SIFT's tail (``ops/sift_tail.py``): the refinement
  with each Newton step computed where a candidate visits it
  (``sift_refine.cu``, ``newton_step.cuh``; plain
  ``features/sift._newton_step_field`` and ``_refine``), the orientation
  (``sift_orient.cu``; ``_orientation_hist`` and ``_peak_angles``) and
  the grid descriptor (``sift_descr.cu``; ``_descriptors``).

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

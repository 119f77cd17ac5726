"""Image operators on tensors, and the two hand-written CUDA kernels
(``gauss_octave``, ``warp_kernel``) with their plain PyTorch versions."""

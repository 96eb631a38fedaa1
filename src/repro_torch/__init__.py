"""PyTorch/CUDA port of the SCBF reproduction (the JAX package ``repro``
is the reference it is checked against).

The layout mirrors ``repro`` module for module.  Entry points run on the
CUDA device unless the caller asks for the CPU (``repro_torch.device``);
the score-and-mask pass of Algorithm 1 runs through the hand-written
Hopper kernels in ``repro_torch.kernels``.
"""

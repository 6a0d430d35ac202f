"""maxstyle_tpu_torch — the PyTorch and CUDA port of the JAX package
``maxstyle_tpu``, for one NVIDIA H100.

It trains the same dual-branch segmentation and reconstruction networks with
MaxStyle adversarial style composition. Plain tensor code is PyTorch in NCHW;
each Pallas kernel that the JAX package wrote for the TPU on the ported path
is a hand-written CUDA kernel for Hopper (``csrc/``), built by ``nvcc`` at
first use (``kernels.py``). Public functions keep the JAX package's layouts
(images [N,H,W,1], labels [N,H,W]) so the two packages compare like with
like. Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

"""esrganplus_tpu_torch — the PyTorch/CUDA port of esrganplus_tpu for NVIDIA
Hopper (H100).

One-shot RRDBNet (ESRGAN+) super-resolution: the plain PyTorch graph on the
CPU, and on the card four hand-written CUDA kernels (``csrc/``) for the RRDB
trunk and the upsample tail. The JAX package ``esrganplus_tpu`` is the
reference the port is tested against; this package never imports it or JAX.
"""

__version__ = "0.1.0"

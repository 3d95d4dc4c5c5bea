"""The workbench: two public kernels that no model path calls.

Counterpart of ``esrganplus_tpu/kernels/workbench``. ``conv.py`` is a single
3×3 stride-1 SAME conv as an implicit GEMM (``conv3x3``); ``rdb.py`` is a
whole ESRGAN+ ResidualDenseBlock in one launch per spatial tile on by-source
weights (``rdb_fused``, forward only). In the JAX package and here they are
public API on no model path: neither ``rrdbnet_forward`` routes through them.
Each has a plain PyTorch twin with the TPU kernel's rounding points; a CPU
tensor goes to the twin, a CUDA tensor launches the hand-written kernel
(``csrc/workbench_conv.cu``, ``csrc/workbench_rdb.cu``) or raises.
"""

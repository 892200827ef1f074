"""Device ops: each hand-written CUDA kernel (``csrc/``) beside its plain
PyTorch version.

  tsm_shift   temporal_shift, fused_residual_relu_shift (forward + backward kernels)
  conv1x1_bn  conv1x1_with_stats (GEMM + BatchNorm-statistics kernel), conv1x1_bn
  _build      nvcc build, ctypes loading, launch counts
"""

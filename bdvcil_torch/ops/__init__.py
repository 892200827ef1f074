"""Device ops: each hand-written CUDA kernel (``csrc/``) beside its plain
PyTorch version.

  tsm_shift    temporal_shift, temporal_shift_kernel (the shift kernel, both
               directions), fused_residual_relu_shift (forward + backward kernels),
               shifted_conv (shift_mode='fused': three F.conv2d, no kernel)
  conv1x1_bn   conv1x1_with_stats and gemm_with_stats (GEMM + BatchNorm-statistics
               kernel), conv1x1_bn (the GEMM, then batchnorm's normalize of its sums)
  batchnorm    train-mode BatchNorm as one autograd Function: statistics, finalize,
               normalize (+ relu) forward; two sums and dx backward (kernels)
  block_fused  the whole-block fused bottleneck forward: conv1x1_stats,
               conv3x3_affine_relu_stats, conv1x1_affine_relu_stats,
               bn_finalize, affine_residual_relu (kernels),
               fused_bottleneck_fwd, plain_bottleneck_fwd
  gemm_plan    the GEMM-with-statistics kernels' tile plans, the R50 shapes
  tf32         a plain emulation of the float32 kernel's 3xTF32 split (tests only)
  _build       nvcc build, ctypes loading, SM count, launch counts, CPU/CUDA dispatch

The input path's ops hold no hand-written kernel; eager PyTorch on the
batch's device:

  augment           YUV420 decode, plane resize, normalize/flip/BGMix,
                    ActorCutMix compositing, tube-CutMix, eval-wire crops
  rand_augment_dev  the 15 RandAugment ops, grouped by op per round
"""

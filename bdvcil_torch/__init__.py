"""bdvcil_torch — the PyTorch/CUDA port of ``bdvcil_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same layout so each module has
an obvious counterpart (``bdvcil_torch/ops/tsm_shift.py`` <->
``bdvcil_tpu/ops/tsm_shift.py`` and so on). It imports ``torch`` only: no
JAX, and nothing of ``bdvcil_tpu``.

Layout:
  ops      temporal shift and the fused block epilogue, the 1x1-conv GEMM
           with a BatchNorm-statistics epilogue; each hand-written CUDA
           kernel (``csrc/``) beside its plain PyTorch version
  models   ResNet-TSM backbone, flax-semantics BatchNorm, incremental heads,
           recognizer, builder, and the JAX <-> torch weight converter
  losses   LSC/NCA, cross-entropy, soft-target CE, feature-KD
  optim    the labeled 6-group SGD with torch-order updates and optax clip
  runtime  train state and the ``base``-method CIL train step

Activations keep the JAX layout at every public function: ``(N*T, H, W, C)``
with time folded into the batch. Inside the model they are NCHW tensors in
``torch.channels_last`` memory, which is the same bytes.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]

"""bdvcil_torch — the PyTorch/CUDA port of ``bdvcil_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same layout so each module has
an obvious counterpart (``bdvcil_torch/ops/tsm_shift.py`` <->
``bdvcil_tpu/ops/tsm_shift.py`` and so on). It imports ``torch`` only: no
JAX, and nothing of ``bdvcil_tpu``.

Layout:
  ops      temporal shift and the fused block epilogue, the 1x1-conv GEMM
           with a BatchNorm-statistics epilogue, train-mode BatchNorm
           forward and backward, the whole-block fused
           bottleneck forward; each hand-written CUDA kernel (``csrc/``)
           beside its plain PyTorch version; the input path's eager ops
           (augment, rand_augment_dev)
  data     the fast input path: the train and eval loaders and the native
           JPEG decoder binding (host half), the input functions and wire
           layout (device half); the slow host pipeline (annotations,
           datasets, transforms, box, rand_augment, host_loader); SampleFrames, a
           synthetic JPEG corpus writer and synthetic wire batches
  models   ResNet-TSM backbone (its s2d stem and 'fused' shift too), the
           TimeSformer (divided space-time attention) backbone,
           flax-semantics and grouped BatchNorm, incremental heads, the PyCIL
           linears, recognizer, builder, the JAX <-> torch weight converter,
           and the ImageNet backbone weights from local files (pretrained)
  parallel data parallelism over torch.distributed, one rank a card: the
           process group, the batch contract, gathers and all-reduces
  losses   LSC/NCA, cross-entropy, soft-target CE, ActorCutMix smoothing, feature-KD
  optim    the labeled 6-group SGD with torch-order updates, optax clip and
           MultiSteps gradient accumulation
  runtime  train state, the CIL train step (base, icarl, icarl_video_mix;
           optional input function) and its K-step form, the eval step and
           its K-step form, the epoch loop (train_epochs, prefetch_to_device),
           run_inference, checkpoints and snapshots
  cil      herding, the per-task data module and the CIL trainer (task loop,
           exemplars, CBF, NME, cil_testing, resume)
  cil_tools  the command-line tools: train_cil, test_cil, test_single_ckpt,
           predict, extract_features, extract_background,
           create_annotation_files
  tools    the plain single-task trainer (tools.train)
  config, config_templates, registry, protocol
           python-file configs, the experiment grid (make_cil_config and
           the main path's settings), type registries, vCLIMB class orders
  utils    meters, the result table, loggers, torch.profiler traces
  bench              the benches in one run, the step headline first
  bench_step         train (or forward) clips/s on device-resident batches,
                     with the step's shares of the card's peaks
  bench_train        end-to-end train throughput from JPEG frames on disk
                     (the BGMix and ActorCutMix families)
  bench_eval         end-to-end inference videos/s, centre crop and TenCrop
  bench_input        the native decoder against the cv2 chain
  bench_randaug      the device RandAugment's cost by op family
  roofline           the HBM and FLOP bounds of the TSM-R50 train step
  bench_block_fused  the block-fused bottleneck against the plain schedule
  profile_kernels, profile_step  device-time profiles of the kernels and the step
  tf32_witness       the float32 kernel's float64 witness over seeds, and a
                     one-accumulator variant's, for the card test's factor
  tf32_variants      the float32 kernel's device time at the block's shapes
                     beside variants that each leave one part of the work out
  bf16_witness       the bf16 core's float64 error on deep products, beside a
                     variant that sums all of K in one accumulator
  profile_e2e        the fed train loop's wall time split into wait, put,
                     dispatch and device, with the producer's phases
  reference_loop     the reference's CIL loop in plain torch (the accuracy
                     yardstick), its synthetic tree and configs; the plain
                     TimeSformer the CPU tests hold the backbone to
  parity_study       paired CIL runs, the port against reference_loop, over
                     seeds: the per-stage accuracy bias and its SE
  bn_ablation        the BatchNorm statistics modes (global, per-device
                     groups, ghost) on a small task
  graft_entry        the driver's entry points: entry (the flagship
                     model's eval forward) and dryrun_multichip (one
                     data-parallel step of each part over n ranks)
  configs            config files of the port (the sanity-check config:
                     one task of all 101 UCF-101 classes), for train_cil

Activations keep the JAX layout at every public function: ``(N*T, H, W, C)``
with time folded into the batch. Inside the model they are NCHW tensors in
``torch.channels_last`` memory, which is the same bytes.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]

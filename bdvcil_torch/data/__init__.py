"""Input path of the port.

The fast path (native decode, then the rest on the device):
  device_pipeline  the device half: wire decode, RandAugment, BGMix,
                   ActorCutMix input functions, the wire layout, the
                   plane-resize tap planners, pinning
  loaders          the host half: FastBGMixLoader, FastACMLoader,
                   FastEvalLoader (centre crop, TenCrop, yuv420_full) and
                   their geometry planners, fed by the native decoder; the
                   trainer's gate of the fast path (fast_pipeline_mismatch)
  native           ctypes binding of the decoder and the JPEG writer
                   (csrc/host/decoder.cpp, jpeg_write.cpp) on the port's own
                   JPEG codec (csrc/host/jpeg_codec.h, no libjpeg), built
                   with g++ at first use into bdvcil_torch/_build/

The slow host pipeline (numpy, cv2, PIL), which the trainer takes when the
config does not ask for the fast path or the decoder is unavailable:
  annotations      annotation files, the label remap, task splits
  datasets         RawframeDataset, BackgroundMixDataset, ActorCutMixDataset
  box              the detection-aware ops of ActorCutMix (box loading, cut
                   outs, the human mask, box-aware resize, crop and flip)
  transforms       the pipeline ops (decode, resize, crops, normalize, ...)
  rand_augment     the whole-clip PIL RandAugment
  host_loader      the threaded DataLoader and collate

Shared:
  sampling         SampleFrames
  corpus           a UCF101-shaped synthetic JPEG corpus from a seed
  synthetic        seeded in-memory wire batches and a loader of them
"""

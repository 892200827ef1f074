"""Input path of the port.

  device_pipeline  the device half: wire decode, RandAugment, BGMix,
                   ActorCutMix input functions, the wire layout, the
                   plane-resize tap planners, pinning
  loaders          the host half: FastBGMixLoader, FastACMLoader and their
                   geometry planners, fed by the native decoder
  native           ctypes binding of native/decoder.cpp and of the JPEG
                   writer, built at first use into bdvcil_torch/_build/
  sampling         SampleFrames
  corpus           a UCF101-shaped synthetic JPEG corpus from a seed
  synthetic        seeded in-memory wire batches and a loader of them
"""

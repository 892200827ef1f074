"""Input path of the port. ``device_pipeline``: the device half of the fast
input path (wire decode, RandAugment, BGMix, ActorCutMix) and the plane-resize
tap planners it needs. The host half (loaders, native decoder binding) is
not ported yet (ROADMAP A.4)."""

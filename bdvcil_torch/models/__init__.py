from .builder import ModelSpec, build_model, init_model_params
from .convert import from_jax_variables, to_jax_variables
from .heads import IncrementalTSMHead, head_param_path, update_fc
from .norm import BatchNorm, GroupedBatchNorm
from .pretrained import load_reference_cil_checkpoint
from .recognizer import KD_TAPS, CILRecognizer2D, average_clips
from .resnet_tsm import ARCH, ResNetTSM
from .timesformer import TimeSformer

__all__ = [
    "ARCH",
    "BatchNorm",
    "CILRecognizer2D",
    "GroupedBatchNorm",
    "IncrementalTSMHead",
    "KD_TAPS",
    "ModelSpec",
    "ResNetTSM",
    "TimeSformer",
    "average_clips",
    "build_model",
    "from_jax_variables",
    "head_param_path",
    "init_model_params",
    "load_reference_cil_checkpoint",
    "to_jax_variables",
    "update_fc",
]

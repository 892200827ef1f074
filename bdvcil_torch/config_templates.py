"""Experiment configs of the port.

``make_cil_config(dataset, seed, num_stages, variant)`` and
``DATASET_PRESETS`` are the port's copy of ``bdvcil_tpu/config_templates.py``:
the whole CIL experiment grid from one template (``configs/`` holds one
two-line file per experiment that calls the JAX package's copy; the port's
entry point takes ``--preset dataset:seed:stages:variant`` or a config file
written against this module). ``parse_preset`` reads that string.

The rest is the main path's configuration, the parts of the ``hmdb51`` preset
and ``bench.py`` that the bench and the step tests run:

TSM-ResNet-50 with 8 segments and shift_div 8; the LSC head with
``nb_proxies=1``, LSCLoss and dropout 0.5; HMDB51's 26 base classes, then 5
per task; feature-KD on ``backbone.layer1..4`` and ``cls_head.avg_pool``
with weights [3, 3, 3, 3, 0.1] and the per-task scale sqrt(classes so far /
classes added); the labeled SGD at lr 0.01, momentum 0.9, weight decay 1e-4,
classifier lr x5, MultiStepLR; the global-norm clip at 1.0 from task 1 on.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

from .models.recognizer import KD_TAPS
from .protocol import adaptive_scale_factors, task_splits_for

HMDB51_BASE_CLASSES = 26
HMDB51_CLASSES_PER_TASK = 5
KD_WEIGHTS = (3.0, 3.0, 3.0, 3.0, 0.1)
GRAD_CLIP = 1.0  # tasks > 0
OPTIMIZER = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
                 paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.01, momentum=0.9,
                 weight_decay=1e-4)
LR_SCHEDULER = dict(type="MultiStepLR", params=dict(milestones=[20, 30], gamma=0.1))
# backbone switches: the JAX defaults, and the two configurations that reach
# the hand-written kernels (they exclude each other)
SWITCHES = {
    "default": dict(shift_mode="pad", conv1x1_mode="xla"),
    "A": dict(shift_mode="pad", conv1x1_mode="pallas_stats"),  # conv1x1_with_stats
    "B": dict(shift_mode="fused_block", conv1x1_mode="xla"),  # fused epilogue
}


def hmdb51_r50_cfg(num_classes: int = HMDB51_BASE_CLASSES, num_segments: int = 8,
                   dropout_ratio: float = 0.5, **backbone) -> Dict:
    """The TSM-R50 + LSC recognizer config; ``backbone`` adds switches such as
    ``shift_mode`` and ``conv1x1_mode``."""
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=50, num_segments=num_segments, shift_div=8,
                      **backbone),
        cls_head=dict(
            type="IncrementalTSMHead", num_classes=num_classes, in_channels=2048,
            inc_head_config=dict(type="LocalSimilarityClassifier", out_features=num_classes,
                                 nb_proxies=1),
            num_segments=num_segments, loss_cls=dict(type="LSCLoss"),
            dropout_ratio=dropout_ratio,
        ),
        test_cfg=dict(average_clips="prob"),
    )


def kd_config(classes_so_far: int, classes_added: int) -> Dict:
    """The base method's KD settings for a task that adds ``classes_added``."""
    return dict(module_names=list(KD_TAPS), module_weights=list(KD_WEIGHTS),
                scale_factor=math.sqrt(classes_so_far / classes_added), exemplar_only=False)


# -- the CIL experiment grid (bdvcil_tpu/config_templates.py:27-364) ----------

IMG_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_bgr=False)

DATASET_PRESETS = {
    "ucf101": dict(
        depth=34,
        in_channels=512,
        pretrained="https://download.pytorch.org/models/resnet34-333f7ec4.pth",
        budget_size=5,
        videos_per_gpu=48,
        accumulate_grad_batches=2,
        workers_per_gpu=4,
        kd_weight_by_module=[0.01, 0.01, 0.01, 0.01, 0.01],
        test_crop="TenCrop",
        test_crop_size=256,
        train_ann="ucf101_train_split_{split}_rawframes.txt",
        val_ann="ucf101_val_split_{split}_rawframes.txt",
    ),
    "hmdb51": dict(
        depth=50,
        in_channels=2048,
        pretrained="https://download.pytorch.org/models/resnet50-0676ba61.pth",
        budget_size=5,
        videos_per_gpu=24,
        accumulate_grad_batches=1,
        workers_per_gpu=4,
        kd_weight_by_module=[3.0, 3.0, 3.0, 3.0, 0.1],
        test_crop="TenCrop",
        test_crop_size=256,
        train_ann="hmdb51_train_split_{split}_rawframes.txt",
        val_ann="hmdb51_val_split_{split}_rawframes.txt",
    ),
    "sthv2": dict(
        depth=50,
        in_channels=2048,
        pretrained="https://download.pytorch.org/models/resnet50-0676ba61.pth",
        budget_size=20,
        videos_per_gpu=12,
        accumulate_grad_batches=1,
        workers_per_gpu=4,
        kd_weight_by_module=[0.5, 0.5, 0.5, 0.5, 1.0],
        test_crop="CenterCrop",
        test_crop_size=224,
        train_ann="sthv2_train_list_rawframes.txt",
        val_ann="sthv2_val_list_rawframes.txt",
    ),
}


def _sgd(fc_scale: float = 5.0) -> Dict[str, Any]:
    return dict(
        type="SGD",
        constructor="CILTSMOptimizerConstructorImprovised",
        paramwise_cfg=dict(fc_lr_scale_factor=fc_scale),
        lr=0.01,
        momentum=0.9,
        weight_decay=0.0001,
    )


def _pipelines(randaug_prob: float, test_crop: str, test_crop_size: int):
    train = [
        dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=8),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(-1, 256)),
        dict(type="RandAugment", n=2, m=10, prob=randaug_prob),
        dict(
            type="MultiScaleCrop",
            input_size=224,
            scales=(1, 0.875, 0.75, 0.66),
            random_crop=False,
            max_wh_scale_gap=1,
            num_fixed_crops=13,
        ),
        dict(type="Resize", scale=(224, 224), keep_ratio=False),
        dict(type="Normalize", **IMG_NORM),
        dict(type="FormatShape", input_format="NHWC"),
        dict(type="Collect", keys=["imgs", "label", "randAug"], meta_keys=[]),
        dict(type="ToTensor", keys=["imgs", "label"]),
    ]
    val = [
        dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=8, test_mode=True),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(-1, 256)),
        dict(type="CenterCrop", crop_size=224),
        dict(type="Normalize", **IMG_NORM),
        dict(type="FormatShape", input_format="NHWC"),
        dict(type="Collect", keys=["imgs", "label"], meta_keys=[]),
        dict(type="ToTensor", keys=["imgs"]),
    ]
    test = [
        dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=8, test_mode=True),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(-1, 256)),
        dict(type=test_crop, crop_size=test_crop_size),
        dict(type="Normalize", **IMG_NORM),
        dict(type="FormatShape", input_format="NHWC"),
        dict(type="Collect", keys=["imgs", "label"], meta_keys=[]),
        dict(type="ToTensor", keys=["imgs"]),
    ]
    feat = [
        dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=8, test_mode=True),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(-1, 256)),
        dict(type="CenterCrop", crop_size=224),
        dict(type="Resize", scale=(224, 224), keep_ratio=False),
        dict(type="Normalize", **IMG_NORM),
        dict(type="FormatShape", input_format="NHWC"),
        dict(type="Collect", keys=["imgs", "label"], meta_keys=[]),
        dict(type="ToTensor", keys=["imgs", "label"]),
    ]
    return train, val, test, feat


def make_cil_config(
    dataset: str,
    seed: int,
    num_stages: int,
    variant: str = "bgmix_plus_randAug",
    data_dir: Optional[str] = None,
    work_dir: Optional[str] = None,
    test_split: int = 1,
) -> Dict[str, Any]:
    preset = DATASET_PRESETS[dataset]
    data_dir = data_dir or os.environ.get("VIDEO_CIL_ROOT", f"data/{dataset}")

    splits = task_splits_for(dataset, seed, num_stages)
    starting_num_classes = len(splits[0])

    bg_subdir = "bg_extract"
    predefined_bg = variant.startswith("predefined_background")
    if predefined_bg:
        bg_subdir = variant.split(":", 1)[1] if ":" in variant else "bg_extract_type_a"
        variant = "bgmix_plus_randAug"

    # augmentation mode (reference mode comment, config :42-52)
    randaug_prob = {
        "bgmix_plus_randAug": 0.75,
        "bgmix_only": -1.0,
        "randaug_only": 2.0,
        "no_aug": -1.0,
        "icarl_bgmix": 0.75,
        "icarl_noaug": -1.0,
        "icarl_video_mix": 0.5,
        "actorcutmix_plus_randaug": 0.75,
    }[variant]

    methods = {
        "icarl_bgmix": "icarl",
        "icarl_noaug": "icarl",
        "icarl_video_mix": "icarl_video_mix",
        "actorcutmix_plus_randaug": "icarl",
    }.get(variant, "base")

    use_lsc = methods == "base"
    train_pl, val_pl, test_pl, feat_pl = _pipelines(
        randaug_prob, preset["test_crop"], preset["test_crop_size"]
    )

    if use_lsc:
        head_cfg = dict(type="LocalSimilarityClassifier", out_features=starting_num_classes, nb_proxies=1)
        loss_cls = dict(type="LSCLoss")
    else:
        head_cfg = dict(type="SimpleLinear", out_features=starting_num_classes)
        loss_cls = (
            dict(type="ACMSmoothCE", alpha=4)
            if variant == "actorcutmix_plus_randaug"
            else dict(type="CrossEntropyLoss")
        )

    model = dict(
        type="CILRecognizer2D",
        backbone=dict(
            type="ResNetTSM",
            pretrained=preset["pretrained"],
            depth=preset["depth"],
            norm_eval=False,
            num_segments=8,
            shift_div=8,
        ),
        cls_head=dict(
            type="IncrementalTSMHead",
            num_classes=starting_num_classes,
            in_channels=preset["in_channels"],
            inc_head_config=head_cfg,
            num_segments=8,
            loss_cls=loss_cls,
            spatial_type="avg",
            consensus=dict(type="AvgConsensus", dim=1),
            dropout_ratio=0.5,
            init_std=0.001,
            is_shift=True,
        ),
        train_cfg=None,
        test_cfg=dict(average_clips="prob"),
    )

    data_root = os.path.join(data_dir, "rawframes")
    background_dir = os.path.join(data_dir, bg_subdir)

    # dataset blocks per variant
    if variant == "actorcutmix_plus_randaug":
        det_file = os.path.join(data_dir, "detections.npy")
        train_ds = dict(
            type="ActorCutMixDataset",
            ann_file="",
            det_file=det_file,
            data_prefix=data_root,
            acm_prob=0.5,
        )
        eval_type = "RawframeDataset"

        def eval_ds(pipeline, **kw):
            return dict(type=eval_type, ann_file="", data_prefix=data_root, pipeline=pipeline, **kw)

        exemplar_ds = dict(
            type="ActorCutMixDataset",
            ann_file="",
            det_file=det_file,
            data_prefix=data_root,
            acm_prob=0.5,
        )
    elif variant in ("icarl_video_mix", "no_aug") or (
        variant == "icarl_noaug"
    ):
        use_bgmix = variant == "no_aug"  # no_aug keeps the dataset type for parity
        ds_type = "BackgroundMixDataset" if use_bgmix else "RawframeDataset"

        def _mk(pipeline, **kw):
            base = dict(type=ds_type, ann_file="", data_prefix=data_root, pipeline=pipeline, **kw)
            if use_bgmix:
                base.update(bg_dir=background_dir, prob=-1, with_randAug=False)
            return base

        train_ds = _mk(train_pl)
        eval_ds = _mk
        exemplar_ds = _mk(train_pl)
    else:  # background-mix families
        def _mk(pipeline, **kw):
            base = dict(
                type="BackgroundMixDataset",
                ann_file="",
                bg_dir=background_dir,
                data_prefix=data_root,
                pipeline=pipeline,
                **kw,
            )
            if predefined_bg:
                base.update(extract_bg_if_not_found=False, map_bg_to_video=False)
            return base

        train_ds = _mk(train_pl, alpha=0.5, with_randAug=True)
        eval_ds = _mk
        exemplar_ds = _mk(train_pl, alpha=0.5, with_randAug=True)

    if "pipeline" not in train_ds:
        train_ds["pipeline"] = train_pl

    variant_tag = {
        "bgmix_plus_randAug": "bgmix_plus_randAug",
        "bgmix_only": "bgmix_only",
        "randaug_only": "randaug_only",
        "no_aug": "no_aug",
        "icarl_bgmix": "icarl_bgmix",
        "icarl_noaug": "icarl_noaug",
        "icarl_video_mix": "icarl_video_mix",
        "actorcutmix_plus_randaug": "ActorCutMix_plus_randAug",
    }[variant]
    default_work_dir = f"work_dirs/{dataset}_seed_{seed}_inc_{num_stages}_stages_{variant_tag}"

    cfg: Dict[str, Any] = dict(
        # run/batch settings
        videos_per_gpu=preset["videos_per_gpu"],
        workers_per_gpu=preset["workers_per_gpu"],
        accumulate_grad_batches=preset["accumulate_grad_batches"],
        testing_videos_per_gpu=8,
        testing_workers_per_gpu=2,
        work_dir=work_dir or default_work_dir,
        task_splits=splits,
        # method switches
        methods=methods,
        starting_task=0,
        ending_task=len(splits) - 1,
        use_nme_classifier=False,
        use_cbf=False,
        cbf_train_backbone=False,
        budget_size=preset["budget_size"],
        storing_methods="videos",
        budget_type="class",
        num_epochs_per_task=50,
        save_best=False,
        randAug_prob=randaug_prob,
        seed=seed,
        model=model,
        # KD config (base method)
        kd_modules_names=[
            "backbone.layer1",
            "backbone.layer2",
            "backbone.layer3",
            "backbone.layer4",
            "cls_head.avg_pool",
        ],
        repr_hook="cls_head.avg_pool",
        kd_exemplar_only=False,
        kd_weight_by_module=preset["kd_weight_by_module"],
        adaptive_scale_factors=adaptive_scale_factors(splits),
        # optimizers
        optimizer=_sgd(5.0),
        optimizer_config=dict(grad_clip=dict(max_norm=20, norm_type=2)),
        lr_scheduler=dict(type="MultiStepLR", params=dict(milestones=[20, 30], gamma=0.1)),
        cbf_num_epochs_per_task=50,
        cbf_optimizer=_sgd(5.0),
        cbf_lr_scheduler=dict(type="MultiStepLR", params=dict(milestones=[20, 30], gamma=0.1)),
        # data
        data_root=data_root,
        test_split=test_split,
        train_ann_file=os.path.join(data_dir, preset["train_ann"].format(split=test_split)),
        val_ann_file=os.path.join(data_dir, preset["val_ann"].format(split=test_split)),
        cil_ann_file_template="{}_task_{}.txt",
        img_norm_cfg=IMG_NORM,
        data=dict(
            train=train_ds,
            val=eval_ds(val_pl, test_mode=True),
            test=eval_ds(test_pl, test_mode=True),
            features_extraction=eval_ds(feat_pl, test_mode=True),
            features_extraction_epochs=1,
            exemplar=exemplar_ds,
        ),
        keep_all_backgrounds=False,
        cbf_full_bg=False,
    )
    if variant == "actorcutmix_plus_randaug":
        cfg["det_file"] = os.path.join(data_dir, "detections.npy")
    if variant == "icarl_video_mix":
        cfg["video_mix_prob"] = 0.5
        cfg["video_mix_alpha"] = 1.0
    return cfg


def parse_preset(preset: str, data_dir: Optional[str] = None,
                 work_dir: Optional[str] = None) -> Dict[str, Any]:
    """``make_cil_config`` from ``'dataset:seed:stages[:variant]'``, e.g.
    ``'hmdb51:1000:6:bgmix_plus_randAug'`` (variant defaults to
    ``bgmix_plus_randAug``; ``predefined_background:<dir>`` keeps its colon)."""
    parts = preset.split(":", 3)
    if len(parts) < 3:
        raise ValueError(f"preset {preset!r}: want 'dataset:seed:stages[:variant]'")
    variant = parts[3] if len(parts) == 4 else "bgmix_plus_randAug"
    return make_cil_config(parts[0], int(parts[1]), int(parts[2]), variant,
                           data_dir=data_dir, work_dir=work_dir)

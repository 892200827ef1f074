"""The accuracy study's data and configs (the port's copy of
``tests/synthetic.make_learnable_rawframe_tree`` and of the study tree of
``tests/test_protocol_parity.py``).

The tree is a learnable synthetic rawframe set: each class owns a base
colour and a coarse spatial gradient, each video adds a colour jitter and
per-frame noise, and val videos carry a larger jitter, so accuracies land
mid-band. It writes the same files, byte for byte, as the JAX side's
tree function, so a JAX study and the port's read one tree. The config is the
reference's 3-task R18-TSM protocol at 56² crops (LSC head, feature-KD,
herding, CBF), on the port's ``Config``.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import cv2
import numpy as np

from ..config import Config
from ..protocol import adaptive_scale_factors

T = 2
CROP = 56
NUM_CLASSES = 6
TASK_SPLITS = [[0, 1], [2, 3], [4, 5]]
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def make_parity_config(root, frames_root, train_ann, val_ann, work_dir, **overrides):
    train_pipeline = [
        dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=T),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(-1, 64)),
        dict(type="RandAugment", n=2, m=10, prob=0.5),
        dict(type="MultiScaleCrop", input_size=CROP, scales=(1, 0.875), random_crop=False,
             max_wh_scale_gap=1, num_fixed_crops=13),
        dict(type="Resize", scale=(CROP, CROP), keep_ratio=False),
        dict(type="Normalize", mean=MEAN, std=STD),
        dict(type="FormatShape", input_format="NHWC"),
        dict(type="Collect", keys=["imgs", "label", "randAug"], meta_keys=[]),
        dict(type="ToTensor", keys=["imgs", "label"]),
    ]
    val_pipeline = [
        dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=T, test_mode=True),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(-1, 64)),
        dict(type="CenterCrop", crop_size=CROP),
        dict(type="Normalize", mean=MEAN, std=STD),
        dict(type="FormatShape", input_format="NHWC"),
        dict(type="Collect", keys=["imgs", "label"], meta_keys=[]),
        dict(type="ToTensor", keys=["imgs"]),
    ]
    bg_dir = str(root / "bg")
    ds = lambda pipeline, **kw: dict(
        type="BackgroundMixDataset",
        ann_file="",
        bg_dir=bg_dir,
        data_prefix=str(frames_root),
        pipeline=pipeline,
        bg_resize=64,
        bg_crop_size=(CROP, CROP),
        **kw,
    )
    cfg = dict(
        work_dir=str(work_dir),
        videos_per_gpu=1,  # global batch = 1 x 8-device mesh / stub world
        workers_per_gpu=2,
        accumulate_grad_batches=1,
        testing_videos_per_gpu=8,
        testing_workers_per_gpu=2,
        task_splits=TASK_SPLITS,
        methods="base",
        starting_task=0,
        ending_task=2,
        use_cbf=True,
        cbf_train_backbone=False,
        budget_size=3,
        storing_methods="videos",
        budget_type="class",
        num_epochs_per_task=14,
        cbf_num_epochs_per_task=10,
        save_best=False,
        log_every_n_steps=50,
        keep_all_backgrounds=False,
        cbf_full_bg=False,
        model=dict(
            type="CILRecognizer2D",
            backbone=dict(type="ResNetTSM", depth=18, num_segments=T, shift_div=8,
                          norm_eval=False),
            cls_head=dict(
                type="IncrementalTSMHead",
                num_classes=2,
                in_channels=512,
                inc_head_config=dict(type="LocalSimilarityClassifier", out_features=2,
                                     nb_proxies=1),
                num_segments=T,
                loss_cls=dict(type="LSCLoss"),
                dropout_ratio=0.0,  # cross-framework RNG cannot match
            ),
            test_cfg=dict(average_clips="prob"),
        ),
        kd_modules_names=["backbone.layer4", "cls_head.avg_pool"],
        kd_weight_by_module=[0.1, 0.1],
        kd_exemplar_only=False,
        adaptive_scale_factors=[1.0, 1.225, 1.414],
        optimizer=dict(
            type="SGD",
            constructor="CILTSMOptimizerConstructorImprovised",
            paramwise_cfg=dict(fc_lr_scale_factor=5.0),
            lr=0.02,
            momentum=0.9,
            weight_decay=1e-4,
        ),
        lr_scheduler=dict(type="MultiStepLR", params=dict(milestones=[20], gamma=0.1)),
        cbf_optimizer=dict(
            type="SGD",
            constructor="CILTSMOptimizerConstructorImprovised",
            paramwise_cfg=dict(fc_lr_scale_factor=1.0),
            lr=0.01,
            momentum=0.9,
            weight_decay=1e-4,
        ),
        cbf_lr_scheduler=dict(type="MultiStepLR", params=dict(milestones=[20], gamma=0.1)),
        data_root=str(frames_root),
        train_ann_file=str(train_ann),
        val_ann_file=str(val_ann),
        cil_ann_file_template="{}_task_{}.txt",
        data=dict(
            train=ds(train_pipeline, alpha=0.5, with_randAug=True),
            val=ds(val_pipeline, test_mode=True),
            test=ds(val_pipeline, test_mode=True),
            features_extraction=ds(val_pipeline, test_mode=True),
            features_extraction_epochs=1,
            exemplar=ds(train_pipeline, alpha=0.5, with_randAug=True),
        ),
        seed=0,
    )
    cfg.update(overrides)
    return Config.fromdict(cfg)


def make_learnable_rawframe_tree(
    root: pathlib.Path,
    num_classes: int = 6,
    train_videos_per_class: int = 6,
    val_videos_per_class: int = 3,
    num_frames: int = 8,
    size=(64, 80),  # (H, W)
    seed: int = 0,
    video_jitter: int = 28,
    noise: int = 40,
    palette_lo: int = 40,
    palette_hi: int = 215,
    val_jitter: Optional[int] = None,
    filename_tmpl: str = "img_{:05}.jpg",
    extra_val_videos_per_class: int = 0,
):
    """Rawframe tree whose CLASS carries the signal (unlike
    ``make_rawframe_tree``, where each video gets an independent random color
    and val accuracy can only measure memorization).

    Each class owns a base color + a coarse spatial pattern; every video adds
    a color jitter and per-frame noise. ``video_jitter``/``noise`` tune the
    difficulty so val accuracy lands in a discriminative band (0.5-0.95) —
    what the protocol-parity and BN-semantics comparisons need.

    Returns (frames_root, train_ann, val_ann).
    """
    rng = np.random.default_rng(seed)
    root = pathlib.Path(root)
    frames_root = root / "rawframes"
    frames_root.mkdir(parents=True, exist_ok=True)
    h, w = size

    # well-separated class colors + a class-keyed horizontal/vertical gradient.
    # 2 levels/channel yields 8 corner colors; >8 classes adds the midpoint
    # level (27 colors). Gated on num_classes so every existing <=8-class tree
    # keeps consuming the rng stream identically (bit-identical trees).
    corners = [palette_lo, palette_hi]
    if num_classes > 8:
        corners = [palette_lo, (palette_lo + palette_hi) // 2, palette_hi]
    palette = rng.permutation(
        np.stack(np.meshgrid(*[corners] * 3), -1).reshape(-1, 3)
    )[:num_classes]
    yy, xx = np.mgrid[0:h, 0:w]
    grads = [yy / h, xx / w, 1 - yy / h, 1 - xx / w]

    train_lines, val_lines = [], []
    for cls in range(num_classes):
        base = palette[cls].astype(np.int64)
        grad = grads[cls % len(grads)][..., None] * 60 - 30
        for vid in range(train_videos_per_class + val_videos_per_class):
            name = f"video_c{cls}_v{vid}"
            vdir = frames_root / name
            vdir.mkdir(parents=True, exist_ok=True)
            # val videos can carry a larger color jitter (val_jitter) than the
            # train split: the resulting irreducible val error pins accuracy
            # in a discriminative band even when training fully converges
            is_val = vid >= train_videos_per_class
            jit_mag = video_jitter if (not is_val or val_jitter is None) else val_jitter
            jit = rng.integers(-jit_mag, jit_mag + 1, size=3)
            for t in range(1, num_frames + 1):
                img = np.clip(
                    base[None, None] + jit[None, None] + grad
                    + rng.integers(-noise, noise + 1, size=(h, w, 3)),
                    0, 255,
                ).astype(np.uint8)
                cv2.imwrite(str(vdir / filename_tmpl.format(t)), img)
            line = f"{name} {num_frames} {cls}"
            (val_lines if vid >= train_videos_per_class else train_lines).append(line)

        # extra val videos drawn from an INDEPENDENT per-class stream, so
        # growing the val set (finer accuracy granularity for the parity
        # tests) leaves every draw above — and therefore the train tree and
        # the base val videos — bit-identical to extra_val_videos_per_class=0
        xrng = np.random.default_rng(np.random.SeedSequence([seed, 1000 + cls]))
        xjit_mag = video_jitter if val_jitter is None else val_jitter
        for j in range(extra_val_videos_per_class):
            name = f"video_c{cls}_xv{j}"
            vdir = frames_root / name
            vdir.mkdir(parents=True, exist_ok=True)
            jit = xrng.integers(-xjit_mag, xjit_mag + 1, size=3)
            for t in range(1, num_frames + 1):
                img = np.clip(
                    base[None, None] + jit[None, None] + grad
                    + xrng.integers(-noise, noise + 1, size=(h, w, 3)),
                    0, 255,
                ).astype(np.uint8)
                cv2.imwrite(str(vdir / filename_tmpl.format(t)), img)
            val_lines.append(f"{name} {num_frames} {cls}")

    train_ann = root / "train_ann.txt"
    val_ann = root / "val_ann.txt"
    train_ann.write_text("\n".join(train_lines) + "\n")
    val_ann.write_text("\n".join(val_lines) + "\n")
    return frames_root, train_ann, val_ann


# the tuned discriminative tree: the JAX study (tools/parity_study.py,
# tests/test_protocol_parity.py) and the port's build from these parameters
TREE_PARAMS = dict(
    num_classes=NUM_CLASSES, train_videos_per_class=6,
    val_videos_per_class=6, num_frames=8, size=(64, 80), seed=3,
    noise=60, video_jitter=42, palette_lo=85, palette_hi=170,
    val_jitter=80, extra_val_videos_per_class=18,
)

# stage-DEPTH variant: the BASELINE.md north star is stated over a 10-stage
# UCF101 protocol, so beyond per-stage bias (3-stage multi-seed study) the
# parity evidence needs stages-deep error ACCUMULATION checked. 12 classes /
# 6 two-class tasks is the deepest protocol the 27-color palette + mid-band
# tuning supports here; palette spread widened (40/215, 3 levels/channel ->
# ~87/channel spacing, comparable to the base tree's 85) so the 12-way task
# stays learnable at the same jitter/noise difficulty.
DEPTH_STAGES = 6
DEPTH_TREE_PARAMS = dict(
    num_classes=2 * DEPTH_STAGES, train_videos_per_class=6,
    val_videos_per_class=6, num_frames=8, size=(64, 80), seed=3,
    noise=60, video_jitter=42, palette_lo=40, palette_hi=215,
    val_jitter=80, extra_val_videos_per_class=18,
)


def depth_overrides(stages: int = DEPTH_STAGES) -> dict:
    """Config overrides turning the 3-task protocol into a ``stages``-deep
    one (two classes per task, KD scales from the reference formula)."""
    splits = [[2 * t, 2 * t + 1] for t in range(stages)]
    return dict(
        task_splits=splits,
        ending_task=stages - 1,
        adaptive_scale_factors=adaptive_scale_factors(splits),
    )


def build_parity_tree(root, params=None):
    """Build the tuned parity tree + background dir under ``root``.

    Difficulty tuned so BOTH metrics land mid-band at every stage (the
    comparison must be discriminative, not at a 0/100 ceiling): training is
    in the robust regime (14 epochs clears the from-scratch convergence
    cliff) while val videos carry a larger color jitter than train
    (val_jitter) so irreducible val error pins accuracies at ~60-85.
    24 val videos/class (48/stage) put the accuracy quantum at ~2.1 pts —
    fine enough that a parity bound measures agreement rather than
    per-video quantization noise (the earlier 6/class tree
    forced 8.3-pt steps and a 15-20 pt tolerance). The extra 18/class come
    from an independent RNG stream (extra_val_videos_per_class) so the
    TRAIN tree is bit-identical to the tuned round-3 setup — regrowing the
    whole tree shifts the shared RNG stream and pushed the torch run off
    the from-scratch convergence cliff (stage accuracies 62->13->2)."""
    root = pathlib.Path(root)
    frames_root, train_ann, val_ann = make_learnable_rawframe_tree(
        root, **(params or TREE_PARAMS)
    )
    # backgrounds for the BackgroundMixDataset pipeline
    bg_dir = root / "bg"
    bg_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(6):
        cv2.imwrite(str(bg_dir / f"bg{i}.jpg"),
                    rng.integers(0, 255, size=(64, 80, 3)).astype(np.uint8))
    return root, frames_root, train_ann, val_ann


def make_icarl_model():
    """The iCaRL-family model dict: SimpleLinear (IncrementalNet) head, CE
    loss. test_cfg says 'prob' ON PURPOSE: the trainer must force 'score'
    for iCaRL methods (trainer.py mirror of icarl.py:34)."""
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=18, num_segments=T, shift_div=8,
                      norm_eval=False),
        cls_head=dict(
            type="IncrementalTSMHead",
            num_classes=2,
            in_channels=512,
            inc_head_config=dict(type="SimpleLinear", out_features=2),
            num_segments=T,
            loss_cls=dict(type="CrossEntropyLoss"),
            dropout_ratio=0.0,  # cross-framework RNG cannot match
        ),
        test_cfg=dict(average_clips="prob"),
    )


def method_overrides(method: str) -> dict:
    """Per-method-family config overrides of the study (the JAX side's, as they are).

    iCaRL-family lr/epochs tuned on the torch side so the linear-CE head
    clears the from-scratch convergence cliff (stage-0 CNN 87.5 at 0.01/24;
    at the base config's 0.02/14 it sits at chance, which would make the
    comparison vacuous): probed over {0.01,0.02,0.05,0.1}x{14..30}.
    video_mix hyperparameters are tuned JOINTLY for both frameworks: at
    prob=0.25/epochs=24 the 12-video task sits right on that cliff and the
    jax side's seed-0 tubemix realization tips it to chance (stage-0 CNN
    45.8; seed 7 converges at 70.8, prob=0 at 85.4 — determinism probes,
    not a tubemix bug, its semantics are pinned by
    test_tubemix_torch_mirrors_device_semantics). Swept prob {0.15, 0.25}
    x epochs {24, 32} identically on both sides: prob=0.15/epochs=32 is
    the strongest mixing that converges for both (stage-0 CNN torch 87.5 /
    jax 77.1), so the comparison stays discriminative while still
    exercising tubemix every epoch."""
    if method == "base":
        return {}
    ov = dict(methods=method, model=make_icarl_model(), num_epochs_per_task=24)
    if method == "icarl_video_mix":
        ov.update(video_mix_prob=0.15, video_mix_alpha=1.0,
                  num_epochs_per_task=32)
    return ov

"""The reference's CIL loop in plain torch (the port's copy of
``tests/torch_cil_reference.py``).

The whole multi-task loop of the reference's libs/cil/cil.py: per-task
training with feature-KD (cil.py:512-556), herding exemplar selection
(memory_selection.py:40-97), exemplar replay, class-balanced fine-tuning
(cil.py:759-795), NME class means (cil.py:1059-1090) and CNN+NME testing
(cil.py:910-983), in the reference's torch semantics (param-group SGD policy
of tsm.py:189-303, Lightning grad-clip 1.0 for tasks>0, MultiStepLR stepped
per epoch), with the iCaRL soft targets (icarl.py:97-130) and tube-CutMix
(icarl_video_mix.py:48-81).

Data is shared with the port's trainer: both build their own
``CILDataModule`` from the same config (different work_dir), whose datasets
and loaders are pure functions of (seed, epoch, idx), so both see the same
pixels in the same order and the comparison isolates model, training and
orchestration. Herding is the port's numpy ``Herding``; only the features
fed to it come from each side's own model. The data module's world size is
held at 8 (the reference's 8-GPU runs, and the JAX study's 8-device mesh):
the global batch is ``videos_per_gpu`` x 8 whatever the machine.

The model is ``model.TorchResNet18TSM``, plain torch; ``device`` places it
and every batch (the card unless the caller asks for the CPU). Its weights are drawn on the CPU from ``torch.manual_seed(
config.seed)`` whatever the device, so a run on the card starts from the
init a CPU run starts from.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..cil.data_module import CILDataModule
from ..cil.herding import Herding
from ..data.host_loader import DataLoader
from ..utils.meters import AverageMeter
from .model import TorchResNet18TSM, lsc_scores

# the reference's 8 GPUs: videos_per_gpu is per device, the batch is global
WORLD_SIZE = 8


class MirrorDataModule(CILDataModule):
    """The port's data module at a fixed world size of ``WORLD_SIZE``."""

    @property
    def world_size(self) -> int:
        return WORLD_SIZE


class _Controller:
    def __init__(self, num_tasks: int):
        self.current_task = 0
        self.num_tasks = num_tasks


def lsc_nca_loss_torch(
    similarities: torch.Tensor,
    targets: torch.Tensor,
    eta: torch.Tensor,
    margin: float = 0.6,
    hinge: bool = True,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NCA loss on cosine similarities — mirror of the reference
    lsc_loss.py:30-58 (and of the port's ``losses.lsc_nca_loss``)."""
    sims = eta.reshape(()) * (similarities - margin)
    sims = sims - sims.max(dim=1, keepdim=True).values.detach()
    b = sims.shape[0]
    pos = sims.gather(1, targets[:, None])  # (B, 1)
    denominator = sims.clone()
    denominator[torch.arange(b, device=sims.device), targets] = 0.0
    losses = pos[:, 0] - torch.log(torch.exp(denominator).sum(dim=-1))
    losses = -losses
    if hinge:
        losses = losses.clamp(min=0.0)
    if sample_weights is not None:
        w = sample_weights.float()
        return (losses * w).sum() / w.sum().clamp(min=1.0)
    return losses.mean()


class TorchCILModel(torch.nn.Module):
    """R18-TSM backbone + growable classifier (reference tsm.py:20-64), with
    the KD taps the protocol needs. ``head_type='lsc'`` is the cosine-proxy
    LSC head (cosine_linear.py:6-55); ``'linear'`` is the IncrementalNet
    plain linear head (inc_net.py:6-37) the iCaRL configs use."""

    def __init__(
        self, num_classes: int, num_segments: int, nb_proxies: int = 1,
        head_type: str = "lsc",
    ):
        super().__init__()
        self.backbone = TorchResNet18TSM(num_segments=num_segments)
        self.num_segments = num_segments
        self.num_classes = num_classes
        self.nb_proxies = nb_proxies
        self.head_type = head_type
        if head_type == "linear":
            # IncrementalNet.reset_parameters (inc_net.py:19-21)
            self.fc_weights = torch.nn.Parameter(torch.empty(num_classes, 512))
            torch.nn.init.kaiming_uniform_(self.fc_weights, nonlinearity="linear")
            self.fc_bias = torch.nn.Parameter(torch.zeros(num_classes))
        else:
            self.fc_weights = torch.nn.Parameter(
                torch.empty(num_classes, nb_proxies * 512)
            )
            # LSC.reset_parameters uses nonlinearity='linear', NOT the
            # default leaky_relu gain (cosine_linear.py:25) — same gain as
            # grow() below; cosine scores are unaffected but weight-decay/
            # momentum dynamics see the reference's init scale
            torch.nn.init.kaiming_normal_(self.fc_weights, nonlinearity="linear")
            self.eta = torch.nn.Parameter(torch.ones(1))

    def grow(self, new_num_classes: int) -> None:
        """update_fc: copy old rows, kaiming-normal new rows with
        nonlinearity='linear' — std 1/sqrt(fan_in), NOT the default
        leaky_relu gain (cosine_linear.py:47 / inc_net.py:26; bias rows
        zeroed). The gain matters for iCaRL: the prev model's grown rows
        feed its softmax soft targets, so oversized rows skew the old-class
        target mass."""
        old = self.fc_weights.data
        new_w = torch.empty(new_num_classes, old.shape[1])  # the CPU's RNG on every device
        torch.nn.init.kaiming_normal_(new_w, nonlinearity="linear")
        new_w[: old.shape[0]] = old.cpu()
        self.fc_weights = torch.nn.Parameter(new_w.to(old.device))
        if self.head_type == "linear":
            new_b = torch.zeros(new_num_classes)
            new_b[: old.shape[0]] = self.fc_bias.data.cpu()
            self.fc_bias = torch.nn.Parameter(new_b.to(old.device))
        self.num_classes = new_num_classes

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B*M, 3, H, W). Returns per-group scores/repr + KD taps."""
        taps = self.backbone(x)
        pooled = taps["layer4"].mean(dim=(2, 3))  # (B*M, C)
        if self.head_type == "linear":
            scores = F.linear(pooled, self.fc_weights, self.fc_bias)
        else:
            scores = lsc_scores(pooled, self.fc_weights, self.num_classes, self.nb_proxies)
        t = self.num_segments
        return {
            "cls_score": scores.view(-1, t, scores.shape[-1]).mean(dim=1),  # (B*G, nc)
            "repr": pooled.view(-1, t, pooled.shape[-1]).mean(dim=1),  # (B*G, C)
            "feats": {
                "backbone.layer1": taps["layer1"],
                "backbone.layer2": taps["layer2"],
                "backbone.layer3": taps["layer3"],
                "backbone.layer4": taps["layer4"],
                "cls_head.avg_pool": pooled,
            },
        }


def tubemix_torch(
    rng: np.random.Generator,
    x: torch.Tensor,
    targets: torch.Tensor,
    num_segments: int,
    alpha: float,
    prob: float,
):
    """Tube-CutMix on a (B*M, 3, H, W) frame batch — the reference
    icarl_video_mix.py:48-81 semantics (one box + one permutation per batch,
    applied to every frame; lam recomputed from the clipped box area).
    Randomness comes from ``rng`` (numpy): the port's step draws from a torch
    generator, so the two sides share the augmentation *distribution*, not
    its draws."""
    bm, c, h, w = x.shape
    b = bm // num_segments
    if rng.uniform() <= 1.0 - prob:
        return x, targets
    perm = rng.permutation(b)
    lam0 = rng.beta(alpha, alpha)
    cut_rat = float(np.sqrt(1.0 - lam0))
    cut_w, cut_h = int(w * cut_rat), int(h * cut_rat)
    cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
    x1 = int(np.clip(cx - cut_w // 2, 0, w))
    y1 = int(np.clip(cy - cut_h // 2, 0, h))
    x2 = int(np.clip(cx + cut_w // 2, 0, w))
    y2 = int(np.clip(cy + cut_h // 2, 0, h))

    clips = x.view(b, num_segments, c, h, w).clone()
    clips[:, :, :, y1:y2, x1:x2] = clips[perm][:, :, :, y1:y2, x1:x2]
    lam = 1.0 - (x2 - x1) * (y2 - y1) / (h * w)
    mixed_targets = targets * lam + targets[perm] * (1.0 - lam)
    return clips.view(bm, c, h, w), mixed_targets


def _to_torch_frames(imgs: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, M, H, W, C) float NHWC batch -> (B*M, 3, H, W) on ``device``."""
    b, m = imgs.shape[0], imgs.shape[1]
    x = torch.from_numpy(np.ascontiguousarray(imgs)).float().to(device)
    if imgs.shape[-1] not in (1, 3) and imgs.shape[2] in (1, 3):  # NCHW batch
        return x.reshape(b * m, *imgs.shape[2:])
    return x.permute(0, 1, 4, 2, 3).reshape(b * m, imgs.shape[-1], *imgs.shape[2:4])


class TorchMiniCIL:
    """The reference CIL loop (cil.py:621-860) in torch, on shared data."""

    def __init__(self, config, device: Union[str, torch.device, None] = None):
        self.config = config
        self.device = resolve_device(device)
        self.seed = config.get("seed", 0)
        torch.manual_seed(self.seed)
        self.task_splits = config.task_splits
        self.num_tasks = min(
            len(config.task_splits), config.get("ending_task", len(config.task_splits) - 1) + 1
        )
        self.num_segments = config.model["backbone"]["num_segments"]
        nb_proxies = config.model["cls_head"]["inc_head_config"].get("nb_proxies", 1)
        # 'base' = LwF-style feature KD (cil.py:512-556); 'icarl' = soft-target
        # CE with prev-model softmax for old-class samples (icarl.py:97-130)
        self.method = config.get("methods", "base")
        head_cfg_type = config.model["cls_head"]["inc_head_config"].get(
            "type", "LocalSimilarityClassifier"
        )
        self.head_type = (
            "linear" if head_cfg_type in ("SimpleLinear", "IncrementalNet") else "lsc"
        )
        # the reference forces raw-score clip averaging for iCaRL (icarl.py:34),
        # mirrored by CILTrainer
        self.average_clips = (
            "score" if self.method in ("icarl", "icarl_video_mix")
            else config.model.get("test_cfg", {}).get("average_clips", "prob")
        )
        self.kd_names = list(config.get("kd_modules_names", []))
        self.kd_weights = list(config.get("kd_weight_by_module", []))
        self.kd_scales = list(config.get("adaptive_scale_factors", []))
        self.kd_exemplar_only = bool(config.get("kd_exemplar_only", False))

        self.data_module = MirrorDataModule(config)
        # the data module only needs current_task / num_tasks from its controller
        self._controller = _Controller(self.num_tasks)
        self.data_module.controller = self._controller

        self.t = 0
        nc0 = self.num_classes(0)
        self.model = TorchCILModel(nc0, self.num_segments, nb_proxies, self.head_type).to(
            self.device)
        self.prev_model: Optional[TorchCILModel] = None

        self.data_module.generate_annotation_file()
        self.data_module.reload_train_dataset(exemplar=None, use_internal_exemplar=False)
        self.data_module.build_validation_datasets()
        self.cnn_matrix: List[List[float]] = []
        self.nme_matrix: List[List[float]] = []

    # -- plumbing ----------------------------------------------------------
    def num_classes(self, task_idx: int) -> int:
        return self.data_module.accumulate_task_size_list[task_idx]

    def _param_groups(self, opt_cfg, freeze_backbone: bool):
        """tsm.py:189-303 group policy (see the header of the port's ``optim`` module)."""
        lr = opt_cfg["lr"]
        wd = opt_cfg.get("weight_decay", 0.0)
        s = (opt_cfg.get("paramwise_cfg") or {}).get("fc_lr_scale_factor", 1.0)
        conv_w, bn_p = [], []
        for name, p in self.model.backbone.named_parameters():
            (conv_w if p.ndim == 4 else bn_p).append(p)
        groups = []
        if not freeze_backbone:
            groups += [
                {"params": conv_w, "lr": lr, "weight_decay": wd},
                {"params": bn_p, "lr": lr, "weight_decay": 0.0},
            ]
        if self.head_type == "linear":
            # classifier bias at 2*scale x lr, no decay (optim.py policy /
            # tsm.py classifier-bias rule)
            head = [self.model.fc_weights, self.model.fc_bias]
            groups += [
                {"params": [self.model.fc_weights], "lr": lr * s, "weight_decay": wd},
                {"params": [self.model.fc_bias], "lr": lr * 2 * s, "weight_decay": 0.0},
            ]
        else:
            head = [self.model.fc_weights, self.model.eta]
            groups += [
                {"params": head, "lr": lr * s, "weight_decay": wd},
            ]
        return groups, ([] if freeze_backbone else conv_w + bn_p) + head

    def _milestones(self, sched_cfg):
        if not sched_cfg or sched_cfg.get("type") != "MultiStepLR":
            return [], 1.0
        p = sched_cfg.get("params", {})
        return list(p.get("milestones", [])), float(p.get("gamma", 0.1))

    # -- phases ------------------------------------------------------------
    def _train_phase(self, loader, num_epochs: int, phase: str) -> None:
        cfg = self.config
        if phase == "cbf":
            opt_cfg, sched_cfg = cfg.cbf_optimizer, cfg.get("cbf_lr_scheduler")
            freeze = not cfg.get("cbf_train_backbone", False)
        else:
            opt_cfg, sched_cfg = cfg.optimizer, cfg.get("lr_scheduler")
            freeze = False
        groups, clip_params = self._param_groups(opt_cfg, freeze)
        opt = torch.optim.SGD(groups, momentum=opt_cfg.get("momentum", 0.0))
        milestones, gamma = self._milestones(sched_cfg)
        sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones, gamma)
        use_kd = self.t > 0 and bool(self.kd_names) and self.method == "base"
        use_prev_targets = self.t > 0 and self.method in ("icarl", "icarl_video_mix")
        # tubemix applies in BOTH phases: the port's trainer passes video_mix
        # to make_train_step from the shared _fit (cil/trainer.py), mirroring the
        # reference's reuse of training_step for inc_step and CBF
        mix_rng = (
            np.random.default_rng([self.seed, self.t, 1 if phase == "cbf" else 0])
            if self.method == "icarl_video_mix"
            else None
        )
        prev_nc = self.num_classes(self.t - 1) if self.t > 0 else 0
        scale = float(self.kd_scales[self.t]) if use_kd and self.t < len(self.kd_scales) else 1.0

        # CBF freeze = backbone params excluded from the optimizer; BN
        # running stats still update (the reference trains the whole module
        # with requires_grad False on the backbone, and the port's step always
        # updates the running statistics) — so the model stays in train mode
        self.model.train()
        for epoch in range(num_epochs):
            loader.set_epoch(epoch)
            for batch in loader:
                x = _to_torch_frames(batch["imgs"], self.device)
                y = torch.from_numpy(np.asarray(batch["label"]).reshape(-1)).long().to(
                    self.device)
                sw = batch.get("sample_weight")
                sw_t = (torch.from_numpy(np.asarray(sw)).float().to(self.device)
                        if sw is not None else None)
                opt.zero_grad()
                if self.method in ("icarl", "icarl_video_mix"):
                    # icarl.py:97-130: CE on soft targets — one-hot for new
                    # classes, prev-model softmax rows for old-class samples.
                    # Order mirrors the port's step (runtime/steps.py): targets
                    # are tubemixed FIRST, then old-class rows are replaced
                    # with the prev model's softmax on the MIXED frames,
                    # selected by the ORIGINAL labels.
                    nc = self.num_classes(self.t)
                    targets = F.one_hot(y, nc).float()
                    if mix_rng is not None:
                        x, targets = tubemix_torch(
                            mix_rng, x, targets, self.num_segments,
                            self.config.get("video_mix_alpha", 1.0),
                            self.config.get("video_mix_prob", 0.5),
                        )
                    out = self.model(x)
                    if use_prev_targets:
                        with torch.no_grad():
                            self.prev_model.eval()
                            prev_scores = self.prev_model(x)["cls_score"]
                            prev_probs = F.softmax(prev_scores, dim=1)
                        old = y < prev_nc
                        targets[old] = prev_probs[old]
                    per = -(targets * F.log_softmax(out["cls_score"], dim=1)).sum(dim=1)
                    if sw_t is not None:
                        loss = (per * sw_t).sum() / sw_t.sum().clamp(min=1.0)
                    else:
                        loss = per.mean()
                else:
                    out = self.model(x)
                    loss = lsc_nca_loss_torch(
                        out["cls_score"], y, self.model.eta, sample_weights=sw_t
                    )
                if use_kd:
                    with torch.no_grad():
                        self.prev_model.eval()
                        prev_out = self.prev_model(x)
                    mask = None
                    if self.kd_exemplar_only:
                        mask = (y < prev_nc).float()
                    if sw_t is not None:
                        mask = sw_t if mask is None else mask * sw_t
                    for name, wgt in zip(self.kd_names, self.kd_weights):
                        cur = out["feats"][name].float()
                        prv = prev_out["feats"][name].float()
                        sq = (cur - prv) ** 2
                        if mask is None:
                            mse = sq.mean()
                        else:
                            per = sq.reshape(sq.shape[0], -1).mean(dim=1)
                            m = mask.repeat_interleave(per.shape[0] // mask.shape[0])
                            mse = (per * m).sum() / m.sum().clamp(min=1.0)
                        loss = loss + scale * wgt * mse
                loss.backward()
                if self.t > 0:  # Lightning gradient_clip_val=1.0 (cil.py:743)
                    torch.nn.utils.clip_grad_norm_(clip_params, 1.0)
                opt.step()
            sched.step()

    # -- prediction --------------------------------------------------------
    @torch.no_grad()
    def _predict(self, loader) -> Dict[str, np.ndarray]:
        self.model.eval()
        scores, reprs, labels = [], [], []
        n_valid = getattr(loader, "num_valid", None)
        for batch in loader:
            x = _to_torch_frames(batch["imgs"], self.device)
            out = self.model(x)
            b = np.asarray(batch["label"]).shape[0]
            scores.append(
                out["cls_score"].reshape(b, -1, out["cls_score"].shape[-1]).cpu().numpy())
            r = out["repr"].reshape(b, -1, out["repr"].shape[-1])
            r = r / r.norm(dim=-1, keepdim=True).clamp(min=1e-12)
            reprs.append(r.cpu().numpy())
            labels.append(np.asarray(batch["label"]).reshape(-1))
        pred = {
            "cls_score": np.concatenate(scores, axis=0),
            "repr": np.concatenate(reprs, axis=0),
            "labels": np.concatenate(labels, axis=0),
        }
        if n_valid is not None:
            pred = {k: v[:n_valid] for k, v in pred.items()}
        return pred

    def _averaged_scores(self, cls_score: np.ndarray) -> np.ndarray:
        mode = self.average_clips
        if mode == "prob":
            e = np.exp(cls_score - cls_score.max(axis=-1, keepdims=True))
            return (e / e.sum(axis=-1, keepdims=True)).mean(axis=1)
        return cls_score.mean(axis=1)

    # -- protocol steps ------------------------------------------------------
    def _build_exemplar(self) -> Dict:
        dm = self.data_module
        loader = dm.features_extraction_dataloader_on_train_dataset(self.t)
        pred = self._predict(loader)
        infos = dm.features_extraction_dataset.video_infos
        meta = {
            "frame_dir": [i["frame_dir"] for i in infos],
            "total_frames": np.array([i["total_frames"] for i in infos]),
            "label": np.array([i["label"] for i in infos]),
            "repr_": pred["repr"].mean(axis=1)[:, None, :],  # (N, 1, C)
            "cls_score": self._averaged_scores(pred["cls_score"])[:, None, :],
        }
        class_indices = [dm.ori_idx_to_inc_idx[i] for i in self.task_splits[self.t]]
        manager = Herding(
            budget_size=self.config.budget_size,
            class_indices=class_indices,
            cosine_distance=True,
            storing_methods=self.config.get("storing_methods", "videos"),
            budget_type=self.config.get("budget_type", "class"),
        )
        return manager.construct_exemplar(meta)

    def _class_means(self) -> np.ndarray:
        dm = self.data_module
        dm.combine_all_exemplar_ann_files(self.t)
        loader = dm.features_extraction_dataloader_on_exemplar(self.t)
        pred = self._predict(loader)
        repr_ = pred["repr"].mean(axis=1)
        labels = pred["labels"]
        return np.stack(
            [repr_[labels == c].mean(axis=0) for c in range(self.num_classes(self.t))]
        )

    def _testing(self, class_means: np.ndarray):
        dm = self.data_module
        loader = dm.get_val_dataloader([0, self.t])
        pred = self._predict(loader)
        preds = np.argmax(self._averaged_scores(pred["cls_score"]), axis=-1)
        labels = pred["labels"]
        cnn, nme = AverageMeter(), AverageMeter()
        means = class_means / np.maximum(
            np.linalg.norm(class_means, axis=-1, keepdims=True), 1e-12
        )
        sims = np.einsum("ngc,kc->ngk", pred["repr"], means).mean(axis=1)
        preds_nme = np.argmax(sims, axis=-1)
        start = 0
        for task_idx in range(self.t + 1):
            n = len(dm.val_datasets[task_idx])
            cnn.update(float((preds[start:start + n] == labels[start:start + n]).mean()) * 100, n)
            nme.update(float((preds_nme[start:start + n] == labels[start:start + n]).mean()) * 100, n)
            start += n
        return cnn, nme

    # -- the outer loop ------------------------------------------------------
    def train(self) -> None:
        while self.t < self.num_tasks:
            self._controller.current_task = self.t
            # inc_step
            loader = self.data_module.train_dataloader()
            self._train_phase(loader, self.config.num_epochs_per_task, phase="inc_step")

            exemplar_meta = self._build_exemplar()
            self.data_module.build_exemplar_from_current_task(exemplar_meta)

            if self.t > 0 and self.config.get("use_cbf", False):
                cbf_ds = self.data_module.build_cbf_dataset()
                cbf_loader = DataLoader(
                    cbf_ds,
                    batch_size=self.config.videos_per_gpu * self.data_module.world_size,
                    shuffle=True,
                    num_workers=self.config.workers_per_gpu,
                    drop_last=False,
                    pad_to_batch=True,
                    seed=self.seed,
                )
                self._train_phase(
                    cbf_loader,
                    self.config.get("cbf_num_epochs_per_task", self.config.num_epochs_per_task),
                    phase="cbf",
                )

            means = self._class_means()
            cnn, nme = self._testing(means)
            self.cnn_matrix.append(list(cnn.values))
            self.nme_matrix.append(list(nme.values))

            # advance
            self.t += 1
            self._controller.current_task = self.t
            if self.t < self.num_tasks:
                self.prev_model = copy.deepcopy(self.model)
                self.prev_model.eval()
                self.model.grow(self.num_classes(self.t))
                self.prev_model.grow(self.num_classes(self.t))
                self.data_module.reload_train_dataset(use_internal_exemplar=True)

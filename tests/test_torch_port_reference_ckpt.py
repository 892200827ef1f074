"""The port's importer of reference CIL checkpoints
(``bdvcil_torch.models.pretrained.load_reference_cil_checkpoint``) against
the JAX package's, on the CPU, f32.

  * a synthetic R18 dict in the reference's layout (the dict of
    tests/test_pretrained.py): the port's ``state_dict``, carried to JAX's
    layout by ``models/convert.to_jax_variables``, equals JAX's
    ``load_reference_cil_checkpoint`` leaf for leaf, exactly;
  * a live torch R18-TSM CIL model (tests/torch_cil_reference.py) with random
    BatchNorm statistics, LSC and linear heads: the port's eval logits on the
    imported weights match the torch model's and JAX's recognizer on JAX's
    import, rtol 2e-4, atol 2e-5 (the tolerance of tests/test_pretrained.py);
  * a TSM-R50 of the port: the imported dict loads with ``strict=True`` under
    every ``shift_mode`` and gives the source model's logits bit for bit;
  * the keys that are dropped, the refusals of a strict load, the eta of the
    current model, and a checkpoint file read back with ``weights_only=True``.
"""

import re
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models.pretrained import load_reference_cil_checkpoint as jax_import
from bdvcil_torch.models import build_model, init_model_params, load_reference_cil_checkpoint
from bdvcil_torch.models.convert import to_jax_variables
from bdvcil_torch.models.pretrained import load_checkpoint_file
from tests.test_pretrained import _torch_style_resnet18_sd
from tests.torch_cil_reference import TorchCILModel
from tests.torch_oracle import randomize_bn_stats
from tests.torch_port_helpers import model_cfg, to_torch

BLOCK_CONV1 = re.compile(r"^(backbone\.layer\d+\.\d+\.conv1)\.weight$")
# the port's head names -> the reference's (IncrementalTSMHead with its loss)
REFERENCE_HEAD = {"cls_head.fc_weights": "cls_head.fc_cls.weights",
                  "cls_head.fc_weight": "cls_head.fc_cls.weight",
                  "cls_head.fc_bias": "cls_head.fc_cls.bias",
                  "cls_head.eta": "cls_head.loss_cls.eta"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_layout(state_dict, prefix=""):
    """A port ``state_dict`` written as the reference writes its checkpoints:
    ``.net`` inside each block's conv1 (TemporalShift's wrapper) and the
    head's names of IncrementalTSMHead and its loss."""
    out = OrderedDict()
    for key, value in state_dict.items():
        key = REFERENCE_HEAD.get(key, BLOCK_CONV1.sub(r"\1.net.weight", key))
        out[prefix + key] = value.detach().clone()
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _reference_r18_dict(rng):
    """tests/test_pretrained.py's reference-layout R18 dict with an LSC head."""
    sd = {}
    for k, v in _torch_style_resnet18_sd(rng).items():
        if k.startswith("fc."):
            continue
        if k.startswith("layer") and ".conv1.weight" in k:
            k = k.replace(".conv1.weight", ".conv1.net.weight")
        sd["backbone." + k] = v
    sd["cls_head.fc_cls.weights"] = rng.standard_normal((5, 512)).astype(np.float32)
    sd["cls_head.loss_cls.eta"] = np.array([2.5], np.float32)
    return sd


def _r18_cfg(t, nc, head_type):
    lsc = head_type == "lsc"
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=18, num_segments=t, shift_div=8),
        cls_head=dict(
            type="IncrementalTSMHead", num_classes=nc, in_channels=512,
            inc_head_config=dict(type="LocalSimilarityClassifier" if lsc else "SimpleLinear",
                                 out_features=nc, nb_proxies=1),
            num_segments=t, loss_cls=dict(type="LSCLoss" if lsc else "CrossEntropyLoss"),
            dropout_ratio=0.0,
        ),
        test_cfg=dict(average_clips="prob"),
    )


def test_synthetic_r18_dict_equals_jax_import_leaf_for_leaf():
    sd = _reference_r18_dict(np.random.default_rng(1))
    got = load_reference_cil_checkpoint({k: torch.from_numpy(v) for k, v in sd.items()})
    want = jax_import(sd)
    got_jax = to_jax_variables(got)
    want_leaves = dict(_leaves(want))
    got_leaves = dict(_leaves(got_jax))
    assert set(got_leaves) == set(want_leaves)
    for path, ref in want_leaves.items():
        ref = np.asarray(ref)
        assert got_leaves[path].shape == ref.shape, path
        np.testing.assert_array_equal(got_leaves[path], ref, err_msg="/".join(path))
    assert not any("num_batches_tracked" in k for k in got)
    # the dict loads into the port's recognizer for the same config
    model = build_model(_r18_cfg(4, 5, "lsc"), device="cpu").module()
    model.load_state_dict(got, strict=True)
    assert float(model.cls_head.eta.detach()) == 2.5


@pytest.mark.parametrize("head_type", ["lsc", "linear"])
def test_live_torch_model_logits_match_the_port_and_jax(head_type):
    t, hw, nc = 4, 32, 5
    torch.manual_seed(0)
    tm = TorchCILModel(num_classes=nc, num_segments=t, head_type=head_type)
    randomize_bn_stats(tm.backbone, seed=11)
    tm.eval()
    sd = OrderedDict()
    for k, v in tm.backbone.state_dict().items():
        if k.startswith("layer") and ".conv1.weight" in k:
            k = k.replace(".conv1.weight", ".conv1.net.weight")
        sd["backbone." + k] = v.detach().clone()
    if head_type == "lsc":
        sd["cls_head.fc_cls.weights"] = tm.fc_weights.detach().clone()
        with torch.no_grad():
            tm.eta.fill_(1.75)  # pinned: the scores do not depend on eta
        sd["cls_head.loss_cls.eta"] = tm.eta.detach().clone()
    else:
        with torch.no_grad():
            tm.fc_bias.copy_(torch.randn(nc, generator=torch.Generator().manual_seed(3)))
        sd["cls_head.fc_cls.weight"] = tm.fc_weights.detach().clone()
        sd["cls_head.fc_cls.bias"] = tm.fc_bias.detach().clone()

    x = np.random.default_rng(3).standard_normal((2, t, hw, hw, 3)).astype(np.float32)
    with torch.no_grad():
        xt = torch.from_numpy(np.transpose(x, (0, 1, 4, 2, 3)).reshape(2 * t, 3, hw, hw))
        want = tm(xt)["cls_score"].reshape(2, nc).numpy()

    cfg = _r18_cfg(t, nc, head_type)
    model = build_model(cfg, device="cpu").module()
    model.load_state_dict(load_reference_cil_checkpoint(sd), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(to_torch(x), train=False)["cls_score"].reshape(2, nc).numpy()
    jvars = jax_import({k: v.numpy() for k, v in sd.items()})
    jax_scores = np.asarray(jax_build_model(cfg).module().apply(
        jvars, jnp.asarray(x), train=False)["cls_score"]).reshape(2, nc)

    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, jax_scores, rtol=2e-4, atol=2e-5)
    if head_type == "lsc":
        assert float(model.cls_head.eta.detach()) == 1.75


def _r50_cfg(shift_mode):
    return model_cfg(50, shift_mode, "xla", 5)


@pytest.fixture(scope="module")
def r50_source():
    """A port TSM-R50 (T=2) with random BatchNorm statistics and head, and its
    checkpoint in the reference's layout under ``current_model.``."""
    model = init_model_params(build_model(_r50_cfg("pad"), device="cpu"), 7)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for name, v in model.state_dict().items():
            if name.endswith("running_var") or name.endswith("bn1.weight"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
            elif name.endswith("running_mean") or name.endswith(".bias"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.2)
        model.cls_head.eta.fill_(3.25)
    return model, reference_layout(model.state_dict(), prefix="current_model.")


@pytest.mark.parametrize("shift_mode", ["pad", "fused", "fused_block"])
def test_r50_import_loads_strictly_under_every_shift_mode(r50_source, shift_mode):
    source, ckpt = r50_source
    imported = load_reference_cil_checkpoint(ckpt)
    assert list(imported) == list(source.state_dict())
    model = build_model(_r50_cfg(shift_mode), device="cpu").module()
    model.load_state_dict(imported, strict=True)
    direct = build_model(_r50_cfg(shift_mode), device="cpu").module()
    direct.load_state_dict(source.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, 32, 32, 3))
                         .astype(np.float32))
    model.eval()
    direct.eval()
    with torch.no_grad():
        got, want = model(x)["cls_score"], direct(x)["cls_score"]
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    if shift_mode == "pad":
        with torch.no_grad():
            assert torch.equal(got, source(x)["cls_score"])


def test_dropped_keys_and_strict_refusals(r50_source):
    source, ckpt = r50_source
    extra = OrderedDict(ckpt)
    extra["current_model.backbone.layer1.0.bn1.num_batches_tracked"] = torch.tensor(7)
    extra["current_model.cls_head.consensus.dummy"] = torch.zeros(1)
    extra["cls_head.consensus.buffer"] = torch.zeros(2)
    for key, value in list(ckpt.items())[:5]:
        extra["prev_model." + key[len("current_model."):]] = value + 1
    extra["prev_model.cls_head.fc_cls.weights"] = torch.zeros(3, 2048)
    imported = load_reference_cil_checkpoint({"state_dict": extra})
    assert list(imported) == list(source.state_dict())
    for name, value in source.state_dict().items():
        assert torch.equal(imported[name], value), name

    model = build_model(_r50_cfg("pad"), device="cpu").module()
    missing = OrderedDict(imported)
    del missing["backbone.layer3.2.conv2.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(missing, strict=True)
    wrong = OrderedDict(imported)
    wrong["backbone.layer2.0.bn1.weight"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict(wrong, strict=True)


def test_eta_is_the_current_models_where_jax_takes_the_previous_ones():
    """A checkpoint that holds both models: the port takes
    ``current_model.cls_head.loss_cls.eta``. JAX's importer
    (bdvcil_tpu/models/pretrained.py:129) matches every key that ends in
    ``loss_cls.eta``, so the previous model's, which comes after it in the
    reference's order, wins there: a divergence from its own docstring,
    pinned here."""
    sd = OrderedDict()
    base = _reference_r18_dict(np.random.default_rng(2))
    for k, v in base.items():
        sd["current_model." + k] = v
    sd["current_model.cls_head.loss_cls.eta"] = np.array([2.0], np.float32)
    for k, v in base.items():
        sd["prev_model." + k] = v
    sd["prev_model.cls_head.loss_cls.eta"] = np.array([7.0], np.float32)

    got = load_reference_cil_checkpoint(sd)
    assert got["cls_head.eta"].tolist() == [2.0]
    assert np.asarray(jax_import(sd)["params"]["head"]["eta"]).tolist() == [7.0]


def test_checkpoint_file_reads_back_with_weights_only(tmp_path, r50_source):
    source, ckpt = r50_source
    path = tmp_path / "ckpt_task_1.pt"
    torch.save(ckpt, path)
    read = load_checkpoint_file(str(path))
    assert list(read) == list(ckpt)
    assert all(torch.equal(read[k], v) for k, v in ckpt.items())
    imported = load_reference_cil_checkpoint(read)
    assert all(torch.equal(imported[k], v) for k, v in source.state_dict().items())

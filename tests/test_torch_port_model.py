"""The port's model (bdvcil_torch/models) against the JAX package's, on the CPU, f32.

Configurations: A = shift_mode 'pad' + conv1x1_mode 'pallas_stats' (the GEMM
with BN statistics; JAX runs it in Pallas interpret mode), B = shift_mode
'fused_block' (the fused epilogue; JAX interprets it on the CPU by itself).

Tolerances:
  * one bottleneck (planes=8, T=2, 8x8, C=32) and one basic block, train mode:
    loss rtol 1e-5; every parameter gradient rtol 1e-4, atol 1e-4 * max|g|;
    batch_stats rtol 1e-5, atol 1e-6;
  * the depth-50 recognizer (T=2, 32x32, B=2, LSC head), eval mode:
    cls_score, repr and every KD tap rtol 1e-4, atol 1e-4. Train mode is
    covered by the one-step tests of test_torch_port_train.py. Full-model
    gradients are not compared: an untrained 50-layer BN ResNet's gradient
    is chaotically ill-conditioned (tests/test_conv1x1_bn.py notes it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.models.resnet_tsm import _BasicBlock, _Bottleneck
from bdvcil_tpu.ops.tsm_shift import temporal_shift as jax_shift
from bdvcil_torch.models import build_model, from_jax_variables, init_model_params
from bdvcil_torch.models.resnet_tsm import BasicBlock, Bottleneck, nchw, nhwc
from bdvcil_torch.ops.tsm_shift import temporal_shift
from tests.torch_port_helpers import (
    CONFIGS, T, block_state_dict, model_cfg, numpy_tree, randomize_bn, to_torch,
)

BLOCK_CASES = [  # (config, stride, is_shift)
    ("A", 1, True), ("A", 2, True), ("A", 1, False), ("B", 1, True), ("B", 2, True),
]


def _run_block_pair(config, jax_cls, port_cls, inplanes, planes, stride, is_shift, seed):
    jax_kw, port_kw = CONFIGS[config]
    if jax_cls is _BasicBlock:
        jax_kw = {k: v for k, v in jax_kw.items() if k != "conv1x1_mode"}
        port_kw = {k: v for k, v in port_kw.items() if k != "conv1x1_mode"}
    fused = config == "B" and is_shift
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * T, 8, 8, inplanes)).astype(np.float32)

    jm = jax_cls(planes=planes, stride=stride, num_segments=T, shift_div=8,
                 is_shift=is_shift, dtype=jnp.float32, norm_dtype=jnp.float32, **jax_kw)
    jx = jnp.asarray(x)
    jxs = jax_shift(jx, T, 8) if fused else None
    jvars = numpy_tree(jm.init(jax.random.PRNGKey(seed), jx, True, jxs))

    def jax_loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": jvars["batch_stats"]},
                            jx, True, jxs, mutable=["batch_stats"])
        if fused:
            out, shifted = out
            return (out ** 2).sum() + 0.5 * (shifted ** 2).sum(), mut
        return (out ** 2).sum(), mut

    (jl, jmut), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jvars["params"])

    pm = port_cls(inplanes, planes, stride, T, 8, is_shift, torch.float32, torch.float32,
                  device="cpu", **port_kw)
    pm.load_state_dict(block_state_dict(jvars), strict=True)
    tx = to_torch(x)
    pxs = nchw(temporal_shift(tx, T, 8)) if fused else None
    out = pm(nchw(tx), True, pxs)
    if fused:
        out, shifted = out
        loss = (out ** 2).sum() + 0.5 * (shifted ** 2).sum()
    else:
        loss = (out ** 2).sum()
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ref_grads = block_state_dict({"params": numpy_tree(jgrads)})
    port_grads = {n: p.grad for n, p in pm.named_parameters()}
    assert set(ref_grads) == set(port_grads)
    for name, ref in ref_grads.items():
        ref = ref.numpy()
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(port_grads[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    ref_stats = block_state_dict({"batch_stats": numpy_tree(jmut["batch_stats"])})
    port_sd = pm.state_dict()
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(port_sd[name].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("config,stride,is_shift", BLOCK_CASES)
def test_bottleneck_matches_jax(config, stride, is_shift):
    _run_block_pair(config, _Bottleneck, Bottleneck, 32, 8, stride, is_shift, seed=0)


@pytest.mark.parametrize("config,stride,is_shift", BLOCK_CASES)
def test_basic_block_matches_jax(config, stride, is_shift):
    _run_block_pair(config, _BasicBlock, BasicBlock, 16, 16 * stride, stride, is_shift, seed=1)


@pytest.mark.parametrize("config", ["A", "B"])
def test_r50_eval_forward_matches_jax(config):
    jax_kw, port_kw = CONFIGS[config]
    # eval mode reaches no Pallas kernel in A, so JAX runs its plain path there
    jax_cfg = model_cfg(50, jax_kw["shift_mode"], "xla", num_classes=5)
    spec = jax_build_model(jax_cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, T, 32, 32, 3)).astype(np.float32)
    variables = randomize_bn(jax_init(spec, jax.random.PRNGKey(3), (1, T, 32, 32, 3)), seed=4)
    ref = spec.module().apply(variables, jnp.asarray(x), train=False)

    pspec = build_model(model_cfg(50, **port_kw, num_classes=5), device="cpu")
    model = pspec.module()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        out = model(to_torch(x), train=False)

    for key in ("cls_score", "repr"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    assert set(out["feats"]) == set(ref["feats"])
    for key, val in ref["feats"].items():
        assert tuple(out["feats"][key].shape) == val.shape
        np.testing.assert_allclose(out["feats"][key].numpy(), np.asarray(val), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_activations_stay_channels_last_inside_the_backbone():
    pspec = build_model(model_cfg(18, "pad", "xla", num_classes=3, classifier="SimpleLinear",
                                  in_channels=512), device="cpu")
    model = init_model_params(pspec, 0)
    feats = model.backbone(torch.zeros((2 * T, 32, 32, 3)), train=False)
    for key, val in feats.items():
        assert val.is_contiguous(), key  # the NHWC view of channels_last bytes
        assert nhwc(nchw(val)).is_contiguous()

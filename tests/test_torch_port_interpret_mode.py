"""``conv1x1_mode='pallas_stats_interpret'`` in the port against the JAX
package, on the CPU, f32.

Both packages are built from one switch dict, ``SWITCHES``, as it stands:
JAX runs the GEMM-with-statistics Pallas kernel in its interpreter, the port
the kernel's plain version (``gemm_stats_plain``) on every device.

Tolerances:
  * one bottleneck (planes=8, T=2, 8x8, C=32), train mode, at the tolerances
    tests/test_torch_port_model.py states for configuration A: loss rtol 1e-5;
    every parameter gradient rtol 1e-4, atol 1e-4 * max|g|; batch_stats rtol
    1e-5, atol 1e-6;
  * a TSM-R50 recognizer (T=2, 32x32, 2 videos, LSC head), train mode, at
    the tolerances the JAX package holds its own interpret path to against
    'xla' at this size (tests/test_conv1x1_bn.py): the loss rtol 2e-3, the
    updated batch_stats rtol 2e-3, atol 1e-3, and cls_score within 2e-3 of
    its largest entry. Full-model gradients are chaotically ill-conditioned
    there (a 1e-6 input perturbation moves some leaves by 33%, the same
    file notes), so they are held in global norm, within 0.1: a wrong
    statistics cotangent moves them by O(1). Per-leaf gradients are held
    tightly on the bottleneck above;
  * the port's 'pallas_stats_interpret' against its 'pallas_stats' on the
    CPU: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bdvcil_tpu.models.resnet_tsm as jax_resnet
import bdvcil_torch.models.resnet_tsm as port_resnet
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.models.resnet_tsm import _Bottleneck
from bdvcil_torch.models import build_model, from_jax_variables
from bdvcil_torch.models.resnet_tsm import Bottleneck, nchw
from tests.torch_port_helpers import (T, block_state_dict, model_cfg, numpy_tree, randomize_bn,
                                      to_torch)

SWITCHES = dict(shift_mode="pad", conv1x1_mode="pallas_stats_interpret")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_block(inplanes, planes, stride, is_shift, **switches):
    return Bottleneck(inplanes, planes, stride, T, 8, is_shift, torch.float32, torch.float32,
                      device="cpu", **switches)


@pytest.mark.parametrize("stride,is_shift", [(1, True), (2, True), (1, False)])
def test_bottleneck_interpret_mode_matches_jax(stride, is_shift):
    inplanes, planes, seed = 32, 8, 3
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * T, 8, 8, inplanes)).astype(np.float32)
    jm = _Bottleneck(planes=planes, stride=stride, num_segments=T, shift_div=8,
                     is_shift=is_shift, dtype=jnp.float32, norm_dtype=jnp.float32, **SWITCHES)
    jx = jnp.asarray(x)
    jvars = numpy_tree(jm.init(jax.random.PRNGKey(seed), jx, True))

    def jax_loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": jvars["batch_stats"]}, jx, True,
                            mutable=["batch_stats"])
        return (out ** 2).sum(), mut

    (jloss, jmut), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jvars["params"])

    pm = _port_block(inplanes, planes, stride, is_shift, **SWITCHES)
    assert pm.use_stats_gemm and pm.interpret_stats_gemm
    pm.load_state_dict(block_state_dict(jvars), strict=True)
    loss = (pm(nchw(to_torch(x)), True) ** 2).sum()
    loss.backward()
    port_grads = {n: p.grad for n, p in pm.named_parameters()}

    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref_grads = block_state_dict({"params": numpy_tree(jgrads)})
    assert set(ref_grads) == set(port_grads)
    for name, ref in ref_grads.items():
        ref = ref.numpy()
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(port_grads[name].numpy(), ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    ref_stats = block_state_dict({"batch_stats": numpy_tree(jmut["batch_stats"])})
    port_sd = pm.state_dict()
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(port_sd[name].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_r50_interpret_mode_train_forward_and_gradients_match_jax():
    cfg = model_cfg(50, num_classes=5, **SWITCHES)
    jspec = jax_build_model(cfg)
    variables = randomize_bn(jax_init(jspec, jax.random.PRNGKey(5), (1, T, 32, 32, 3)), seed=6)
    x = np.random.default_rng(5).standard_normal((2, T, 32, 32, 3)).astype(np.float32)
    jx = jnp.asarray(x)

    def jax_loss(params):
        out, mut = jspec.module().apply({"params": params,
                                         "batch_stats": variables["batch_stats"]},
                                        jx, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                        mutable=["batch_stats"])
        return (out["cls_score"] ** 2).sum(), (out, mut)

    (jloss, (ref, mut)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(variables["params"])

    model = build_model(cfg, device="cpu").module()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    out = model(to_torch(x), train=True)
    loss = (out["cls_score"] ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-3)
    ref_scores = np.asarray(ref["cls_score"])
    np.testing.assert_allclose(out["cls_score"].detach().numpy(), ref_scores, rtol=2e-3,
                               atol=2e-3 * float(np.abs(ref_scores).max()))
    want = from_jax_variables({"batch_stats": numpy_tree(mut["batch_stats"])})
    got = model.state_dict()
    assert len(want) == 2 * 53  # the stem BN and 52 in the blocks, mean and var each
    for name, ref_v in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref_v.numpy(), rtol=2e-3, atol=1e-3,
                                   err_msg=name)
    ref_grads = from_jax_variables({"params": numpy_tree(jgrads)})
    port_grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in model.named_parameters()}  # eta: no gradient without the loss
    assert set(ref_grads) == set(port_grads)
    gap = sum(float(torch.sum((port_grads[n] - g) ** 2)) for n, g in ref_grads.items())
    norm = sum(float(torch.sum(g ** 2)) for g in ref_grads.values())
    assert gap ** 0.5 <= 0.1 * norm ** 0.5


def test_interpret_mode_equals_pallas_stats_on_the_cpu_bit_for_bit():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2 * T, 8, 8, 32)).astype(np.float32)
    runs = {}
    for mode in ("pallas_stats", "pallas_stats_interpret"):
        torch.manual_seed(0)
        pm = _port_block(32, 8, 1, True, shift_mode="pad", conv1x1_mode=mode)
        for p in pm.parameters():
            torch.nn.init.normal_(p, 0.0, 0.2)
        out = pm(nchw(to_torch(x)), True)
        (out ** 2).sum().backward()
        runs[mode] = (out.detach(), {n: p.grad for n, p in pm.named_parameters()},
                      pm.state_dict())
    (o1, g1, s1), (o2, g2, s2) = runs.values()
    assert torch.equal(o1, o2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def _count_calls(monkeypatch, module):
    calls = []
    real = module.conv1x1_bn

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "conv1x1_bn", counted)
    return calls


@pytest.mark.parametrize("conv1x1_mode", ["pallas_stats", "pallas_stats_interpret"])
@pytest.mark.parametrize("switches,uses_gemm", [
    (dict(shift_mode="pad"), True),
    (dict(shift_mode="pad", bn_groups=2), False),
    (dict(shift_mode="fused_block"), False),
])
def test_stats_gemm_conditions_match_jax(monkeypatch, conv1x1_mode, switches, uses_gemm):
    """The GEMM-with-statistics path runs under both names, and steps aside
    for grouped BatchNorm and the fused block, in both packages."""
    jax_calls = _count_calls(monkeypatch, jax_resnet)
    port_calls = _count_calls(monkeypatch, port_resnet)
    x = np.random.default_rng(1).standard_normal((2 * T, 8, 8, 32)).astype(np.float32)
    fused = switches["shift_mode"] == "fused_block"
    jm = _Bottleneck(planes=8, stride=1, num_segments=T, shift_div=8, is_shift=True,
                     dtype=jnp.float32, norm_dtype=jnp.float32, conv1x1_mode=conv1x1_mode,
                     **switches)
    jx = jnp.asarray(x)
    # traced, not run: the JAX package's 'pallas_stats' kernel has no CPU lowering
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jx, True, jx if fused else None))
    pm = _port_block(32, 8, 1, True, conv1x1_mode=conv1x1_mode, **switches)
    h = nchw(to_torch(x))
    pm(h, True, h if fused else None)
    assert pm.use_stats_gemm is uses_gemm
    assert (len(jax_calls) > 0) is uses_gemm
    assert len(port_calls) == (2 if uses_gemm else 0)


def test_jax_config_with_the_interpret_mode_builds_unchanged():
    cfg = model_cfg(50, num_classes=5, **SWITCHES)
    spec = build_model(cfg, device="cpu")
    assert spec.backbone_kwargs["conv1x1_mode"] == "pallas_stats_interpret"
    model = spec.module()
    blocks = [b for s in range(1, 5) for b in getattr(model.backbone, f"layer{s}")]
    assert len(blocks) == 16
    assert all(b.use_stats_gemm and b.interpret_stats_gemm for b in blocks)

"""The backbone's switches that no main-path config reaches, and the PyCIL
linears, against the JAX package, on the CPU, f32.

Both sides get the same numpy weights through ``models/convert.py``.

  * ``shift_mode='fused'`` (conv1 through ``ops/tsm_shift.shifted_conv``),
    ``bn_groups=2`` and ``bn_stats_rows=2`` (``GroupedBatchNorm``), on one
    bottleneck (planes=8, T=2, 8x8, C=32; config A's switch, so the
    GEMM-with-statistics path must step aside for grouped BatchNorm) and one
    basic block, train mode: loss rtol 1e-5; every parameter gradient rtol
    1e-4, atol 1e-4 * max|g|; batch_stats rtol 1e-5, atol 1e-6 (the
    tolerances of tests/test_torch_port_model.py).
  * the ``s2d`` stem against JAX's ``_S2DStem`` (output and gradients, rtol
    1e-5, atol 1e-6 of the largest entry) and against the plain 7x7/s2 stem
    it replaces (rtol 1e-4, atol 1e-5: another summation order).
  * a whole R18 recognizer in train mode under each switch (8 videos at
    64²; ghost statistics from 8 of 16 rows, or 4 of each group's 8), and an
    R50 in eval mode with the s2d stem and the fused shift: cls_score, repr
    and the updated batch statistics rtol 1e-4, atol 1e-4.
  * ``models/linears.py``: each module and function against JAX's, output
    and parameter gradients rtol 1e-5, and ``linear_from_jax`` /
    ``linear_to_jax`` round trips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.models import linears as jl
from bdvcil_tpu.models.resnet_tsm import _BasicBlock, _Bottleneck, _S2DStem
from bdvcil_torch.models import build_model, from_jax_variables
from bdvcil_torch.models import linears as pl
from bdvcil_torch.models.convert import linear_from_jax, linear_to_jax
from bdvcil_torch.models.norm import GroupedBatchNorm
from bdvcil_torch.models.resnet_tsm import (BasicBlock, Bottleneck, Conv2d, S2DStem,
                                            ShiftedConv2d, nchw, nhwc)
from tests.torch_port_helpers import (T, block_state_dict, model_cfg, numpy_tree, randomize_bn,
                                      to_torch)

MODES = {  # name: backbone switches, the same on both sides
    "fused": dict(shift_mode="fused"),
    "groups2": dict(bn_groups=2),
    "stats_rows2": dict(bn_stats_rows=2),
    "groups2_rows1": dict(bn_groups=2, bn_stats_rows=1),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_block_pair(jax_cls, port_cls, inplanes, planes, stride, mode, seed):
    kw = dict(MODES[mode])
    if jax_cls is _Bottleneck:
        jax_kw = dict(kw, conv1x1_mode="pallas_stats_interpret")
        port_kw = dict(kw, conv1x1_mode="pallas_stats")
    else:
        jax_kw = port_kw = kw
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * T, 8, 8, inplanes)).astype(np.float32)

    jm = jax_cls(planes=planes, stride=stride, num_segments=T, shift_div=8, is_shift=True,
                 dtype=jnp.float32, norm_dtype=jnp.float32, **jax_kw)
    jx = jnp.asarray(x)
    jvars = numpy_tree(jm.init(jax.random.PRNGKey(seed), jx, True))

    def jax_loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": jvars["batch_stats"]}, jx, True,
                            mutable=["batch_stats"])
        return (out ** 2).sum(), mut

    (jloss, jmut), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jvars["params"])

    pm = port_cls(inplanes, planes, stride, T, 8, True, torch.float32, torch.float32,
                  device="cpu", **port_kw)
    if jax_cls is _Bottleneck:
        assert not pm.use_stats_gemm or mode == "fused"
    pm.load_state_dict(block_state_dict(jvars), strict=True)
    loss = (pm(nchw(to_torch(x)), True) ** 2).sum()
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref_grads = block_state_dict({"params": numpy_tree(jgrads)})
    port_grads = {n: p.grad for n, p in pm.named_parameters()}
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
    return pm


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_modes_match_jax(mode, stride):
    pm = _run_block_pair(_Bottleneck, Bottleneck, 32, 8, stride, mode, seed=0)
    if mode == "fused":
        assert isinstance(pm.conv1, ShiftedConv2d) and not pm.is_shift
    if "groups" in mode or "rows" in mode:
        assert isinstance(pm.bn3, GroupedBatchNorm) and not pm.use_stats_gemm


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("stride", [1, 2])
def test_basic_block_modes_match_jax(mode, stride):
    _run_block_pair(_BasicBlock, BasicBlock, 16, 16 * stride, stride, mode, seed=1)


def test_s2d_stem_matches_jax_and_the_plain_stem():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    g = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    jm = _S2DStem(64, jnp.float32)
    jvars = numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def f(xx, params):
        return jnp.sum(jm.apply({"params": params}, xx) * g)

    jy = jm.apply(jvars, jnp.asarray(x))
    jgx, jgp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jvars["params"])

    stem = S2DStem(64)
    weight = torch.from_numpy(np.ascontiguousarray(jvars["params"]["kernel"].transpose(3, 2, 0, 1)))
    with torch.no_grad():
        stem.weight.copy_(weight)
    tx = nchw(to_torch(x)).requires_grad_(True)
    y = stem(tx)
    (nhwc(y) * to_torch(g)).sum().backward()
    for got, ref in ((nhwc(y).detach().numpy(), np.asarray(jy)),
                     (nhwc(tx.grad).numpy(), np.asarray(jgx)),
                     (stem.weight.grad.numpy(), np.asarray(jgp["kernel"]).transpose(3, 2, 0, 1))):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())

    plain = Conv2d(3, 64, 7, 2, 3)
    with torch.no_grad():
        plain.weight.copy_(weight)
        np.testing.assert_allclose(stem(nchw(to_torch(x))).numpy(),
                                   plain(nchw(to_torch(x))).numpy(), rtol=1e-4, atol=1e-5)


def _train_forward_pair(depth, backbone, seed, train, videos=4, hw=32):
    cfg = model_cfg(depth, "pad", "xla", 5, in_channels=512 if depth < 50 else 2048)
    cfg["backbone"].update(backbone)
    jspec = jax_build_model(cfg)
    variables = randomize_bn(jax_init(jspec, jax.random.PRNGKey(seed), (1, T, 32, 32, 3)),
                             seed=seed + 1)
    x = np.random.default_rng(seed).standard_normal((videos, T, hw, hw, 3)).astype(np.float32)
    if train:
        ref, mut = jspec.module().apply(variables, jnp.asarray(x), train=True,
                                        rngs={"dropout": jax.random.PRNGKey(0)},
                                        mutable=["batch_stats"])
    else:
        ref, mut = jspec.module().apply(variables, jnp.asarray(x), train=False), None
    model = build_model(cfg, device="cpu").module()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        out = model(to_torch(x), train=train)
    for key in ("cls_score", "repr"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    if mut is not None:
        want = from_jax_variables({"batch_stats": numpy_tree(mut["batch_stats"])})
        got = model.state_dict()
        for name, ref_v in want.items():
            np.testing.assert_allclose(got[name].numpy(), ref_v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)


# whole-model switches; ghost statistics take enough rows that layer4's
# statistics (2x2 pixels at 64²) are not a few values divided by their spread
WHOLE_MODEL = {
    "fused": MODES["fused"],
    "groups2": MODES["groups2"],
    "s2d": dict(stem_mode="s2d"),
    "stats_rows8": dict(bn_stats_rows=8),
    "groups2_rows4": dict(bn_groups=2, bn_stats_rows=4),
}


@pytest.mark.parametrize("mode", list(WHOLE_MODEL))
def test_r18_train_forward_under_each_switch_matches_jax(mode):
    _train_forward_pair(18, WHOLE_MODEL[mode], seed=5, train=True, videos=8, hw=64)


def test_r50_eval_forward_with_the_s2d_stem_and_the_fused_shift_matches_jax():
    _train_forward_pair(50, dict(stem_mode="s2d", shift_mode="fused"), seed=7, train=False)


# --- models/linears.py -------------------------------------------------------------


def _linear_pair(jmod, pmod, x, seed):
    params = numpy_tree(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    pmod.load_state_dict(linear_from_jax(params), strict=True)
    rt = linear_to_jax(pmod.state_dict())
    assert jax.tree.structure(rt) == jax.tree.structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(params)))

    def f(p):
        out = jmod.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * jnp.arange(out.size, dtype=jnp.float32).reshape(out.shape) / out.size)

    jout = jmod.apply({"params": params}, jnp.asarray(x))
    jgrads = linear_from_jax(numpy_tree(jax.grad(f)(params)))
    out = pmod(to_torch(x))
    weights = torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape) / out.numel()
    (out * weights).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    for name, p in pmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


X = np.random.default_rng(11).standard_normal((6, 16)).astype(np.float32)


def test_simple_linear_matches_jax():
    _linear_pair(jl.SimpleLinear(5), pl.SimpleLinear(16, 5), X, 0)


@pytest.mark.parametrize("nb_proxies,to_reduce,sigma", [(1, False, True), (3, True, True),
                                                        (3, False, False)])
def test_cosine_linear_matches_jax(nb_proxies, to_reduce, sigma):
    _linear_pair(jl.CosineLinear(5, nb_proxies, to_reduce, sigma),
                 pl.CosineLinear(16, 5, nb_proxies, to_reduce, sigma), X, 1)


@pytest.mark.parametrize("nb_proxies,sigma", [(1, True), (2, False)])
def test_split_cosine_linear_matches_jax(nb_proxies, sigma):
    _linear_pair(jl.SplitCosineLinear(3, 4, nb_proxies, sigma),
                 pl.SplitCosineLinear(16, 3, 4, nb_proxies, sigma), X, 2)


@pytest.mark.parametrize("nb_proxies", [1, 3])
def test_reduce_proxies_matches_jax(nb_proxies):
    sims = np.random.default_rng(4).standard_normal((5, 4 * nb_proxies)).astype(np.float32)
    np.testing.assert_allclose(pl.reduce_proxies(to_torch(sims), nb_proxies).numpy(),
                               np.asarray(jl.reduce_proxies(jnp.asarray(sims), nb_proxies)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("exclude_pos,hinge,weighted", [(True, True, False), (True, False, True),
                                                        (False, True, False)])
def test_nca_loss_matches_jax(exclude_pos, hinge, weighted):
    rng = np.random.default_rng(5)
    sims = rng.uniform(-1, 1, (6, 4)).astype(np.float32)
    targets = rng.integers(0, 4, 6)
    cw = rng.uniform(0.5, 1.5, 4).astype(np.float32) if weighted else None
    want = jl.nca_loss(jnp.asarray(sims), jnp.asarray(targets), scale=2.0, margin=0.4,
                       class_weights=None if cw is None else jnp.asarray(cw),
                       exclude_pos_denominator=exclude_pos, hinge_proxynca=hinge)
    got = pl.nca_loss(to_torch(sims), torch.from_numpy(targets), scale=2.0, margin=0.4,
                      class_weights=None if cw is None else to_torch(cw),
                      exclude_pos_denominator=exclude_pos, hinge_proxynca=hinge)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_linear_converter_refuses_unknown_leaves():
    with pytest.raises(KeyError):
        linear_from_jax({"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        linear_to_jax({"fc3.weight": torch.zeros(2, 2)})

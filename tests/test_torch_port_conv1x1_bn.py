"""The port's ``conv1x1_bn`` (bdvcil_torch/ops/conv1x1_bn.py) in train mode, on
the CPU, in float64. On a card its normalize (``ops/batchnorm``'s Function)
hands the GEMM's backward the whole dy, the paths through the sums included,
so the GEMM's backward folds nothing: that analytic backward (its plain
versions, the kernels' twins, then the GEMM's own backward) equals the one
autograd gives when the sums are differentiable expressions whose cotangents
are folded into dy, as ``conv1x1_bn`` on the CPU runs.
"""

import numpy as np
import pytest
import torch

from bdvcil_torch.models.norm import BatchNorm as PortBatchNorm
from bdvcil_torch.ops import batchnorm as port_bn
from bdvcil_torch.ops import conv1x1_bn as port_conv

EPS = port_conv.EPS


def _old_conv1x1_bn_train(x, w, bn, relu):
    """The port's conv1x1_bn before ops/batchnorm, in float64: the GEMM's
    (y, sum y, sum y^2) as differentiable expressions, the eager affine from
    the sums, the normalize; autograd folds the sums' cotangents into dy."""
    y = x.reshape(-1, x.shape[-1]) @ w
    s1, s2 = y.sum(0), (y * y).sum(0)
    n = float(y.shape[0])
    mean = s1 / n
    var = s2 / n - mean * mean
    inv = bn.weight / torch.sqrt(var + EPS)
    shift = bn.bias - mean * inv
    out = (y * inv + shift).reshape(*x.shape[:-1], w.shape[1])
    return torch.relu(out) if relu else out


def _analytic_conv1x1_bn_grads(x, wc, bn, g, relu):
    """The normalize's analytic backward from the GEMM's sums (the plain
    versions of ``ops/batchnorm``) and the GEMM's own backward of the whole
    dy: (dx, dconv_weight, dweight, dbias)."""
    n, k = wc.shape[:2]
    xm, wm = x.detach().reshape(-1, k), wc.detach().reshape(n, k).t()
    y = xm @ wm
    rows = float(y.shape[0])
    spec = port_bn._Spec(True, relu, torch.float64, rows, EPS, 1, True)
    coef = port_bn.finalize_plain(y.sum(0), (y * y).sum(0), rows, bn, spec)
    dy, dweight, dbias = port_bn._backward(port_bn.PLAIN, g.reshape(-1, n), y, coef, rows,
                                           spec, True)
    return (dy @ wm.t()).reshape(x.shape), (xm.t() @ dy).t().reshape(wc.shape), dweight, dbias


@pytest.mark.parametrize("backward", ["conv1x1_bn", "analytic"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(4, 3, 5, 24, 16), (2, 2, 2, 8, 40)])
def test_conv1x1_bn_backward_equals_the_old_fold_in_float64(monkeypatch, shape, relu,
                                                            backward):
    """conv1x1_bn on the CPU, or the analytic backward that hands the GEMM the
    whole dy (Tensor.float a no-op so all stays float64), against the sums
    folded into dy by autograd: dx, the conv weight's, the BatchNorm
    weight's and bias's gradients, and the running statistics."""
    monkeypatch.setattr(torch.Tensor, "float", lambda self: self)
    nt, h, w_, k, n = shape
    rng = np.random.default_rng(sum(shape))
    x0 = torch.from_numpy(rng.standard_normal((nt, h, w_, k)))
    wc0 = torch.from_numpy(rng.standard_normal((n, k, 1, 1)) * 0.3)
    g = torch.from_numpy(rng.standard_normal((nt, h, w_, n)))
    scale, bias = rng.random(n) + 0.5, rng.standard_normal(n) * 0.2
    grads, stats = [], []
    for new in (True, False):
        bn = PortBatchNorm(n).double()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        x, wc = x0.clone().requires_grad_(True), wc0.clone().requires_grad_(True)
        if new and backward == "analytic":
            with torch.no_grad():
                grads.append(_analytic_conv1x1_bn_grads(x, wc, bn, g, relu))
            stats.append((bn.running_mean.clone(), bn.running_var.clone()))
            continue
        if new:
            out = port_conv.conv1x1_bn(x, wc, bn, True, torch.float64, torch.float64,
                                       relu=relu)
        else:
            out = _old_conv1x1_bn_train(x, wc.reshape(n, k).t(), bn, relu)
            m = bn.momentum
            with torch.no_grad():
                y = x.reshape(-1, k) @ wc.reshape(n, k).t()
                mean, var = y.mean(0), (y * y).mean(0) - y.mean(0) ** 2
                bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
                bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        out.backward(g)
        grads.append((x.grad, wc.grad, bn.weight.grad, bn.bias.grad))
        stats.append((bn.running_mean.clone(), bn.running_var.clone()))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-12 * float(want.abs().max()))
    for got, want in zip(*stats):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)

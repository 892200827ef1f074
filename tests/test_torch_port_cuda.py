"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch; there run it without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances: the fused epilogue kernels are bit-exact (f32 add rounded once,
as a bf16 add is); conv1x1_with_stats: y within one bf16 ulp (accumulation
order; near zero the ulp is taken at 1/256 of the tensor's rms), the
statistics rtol 1e-3 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from bdvcil_torch.ops import _build
from bdvcil_torch.ops import conv1x1_bn as port_conv
from bdvcil_torch.ops import tsm_shift as port_tsm

pytestmark = pytest.mark.cuda

T = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|, with |x| floored at 1/256 of the tensor's rms:
    near zero the f32 accumulation order, not the rounding, sets the error."""
    floor = max(float(x.float().pow(2).mean().sqrt()) / 256, float(np.finfo(np.float32).tiny))
    mag = torch.clamp(x.abs(), min=floor)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2 * T, 4, 4, 32), (8 * T, 7, 7, 256), (4, 3, 5, 12)])
def test_fused_kernels_bit_exact(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    h, i, g_out, g_sh = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                         for _ in range(4))
    _build.LAUNCHES.clear()
    out, sh = port_tsm.fused_fwd(h, i, T, 8)
    g_in = port_tsm.fused_bwd(out, g_out, g_sh, T, 8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[port_tsm.FWD] == 1 and _build.LAUNCHES[port_tsm.BWD] == 1
    r_out, r_sh = port_tsm.fused_residual_relu_shift_plain(h, i, T, 8)
    r_g = port_tsm.fused_residual_relu_shift_bwd_plain(r_out, g_out, g_sh, T, 8)
    assert torch.equal(out, r_out)
    assert torch.equal(sh, r_sh)
    assert torch.equal(g_in, r_g)


@pytest.mark.parametrize("mkn", [(300, 64, 64), (6272, 512, 2048), (1000, 256, 128),
                                 (128, 32, 64)])
def test_conv1x1_kernel_matches_plain(cuda, mkn):
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((m, 1, 1, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    _build.LAUNCHES.clear()
    y, s1, s2 = port_conv.conv1x1_with_stats_fwd(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[port_conv.KERNEL] == 1
    ry, rs1, rs2 = port_conv.conv1x1_with_stats_plain(x, w)
    assert bool(((y.float() - ry.float()).abs() <= _bf16_ulp(ry.float())).all())
    torch.testing.assert_close(s1, rs1, rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(s2, rs2, rtol=1e-3, atol=1e-2)


def test_conv1x1_kernel_statistics_are_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4096, 1, 1, 256), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((256, 128), generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    first = port_conv.conv1x1_with_stats_fwd(x, w)
    second = port_conv.conv1x1_with_stats_fwd(x, w)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 2, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # K % 32 != 0
        port_conv.conv1x1_with_stats_fwd(x, torch.zeros((48, 64), device=cuda,
                                                        dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        port_conv.conv1x1_with_stats_fwd(x.float()[..., :32], torch.zeros((32, 64), device=cuda))
    with pytest.raises(ValueError):  # not contiguous
        port_tsm.fused_fwd(x[..., ::2], x[..., ::2], 2, 8)

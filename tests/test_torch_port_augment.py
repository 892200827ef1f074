"""The port's augmentation ops (bdvcil_torch/ops/augment.py) and plane-resize
taps (bdvcil_torch/data/device_pipeline.py) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed at small sizes (B <= 4, T <= 4, crops
of 32-64 px). The integer ops are held bit for bit; tubemix,
fused_train_augment and background_blend, f32, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.data import device_pipeline as jdp
from bdvcil_tpu.ops import augment as jaug
from bdvcil_torch.data import device_pipeline as pdp
from bdvcil_torch.ops import augment as paug
from tests.torch_port_helpers import jax_tubemix_draws, to_torch


def _u8(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# (sw, sh, dw, dh, cx, cy, out): downscale, upscale, identity, windows
# clamped at the far edge and at negative offsets, and the squash fallback
GEOMETRIES = [
    (80, 60, 48, 36, 5, 2, 32),
    (40, 30, 72, 54, 10, 7, 32),
    (48, 40, 48, 40, 8, 3, 32),
    (96, 64, 70, 50, 60, 40, 32),
    (64, 48, 40, 34, -3, -1, 32),
    (50, 40, 30, 20, 0, 0, 32),  # window larger than the target: None
    (320, 240, 298, 224, 37, 0, 64),
]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_plane_resize_taps_equal_jax(geom):
    port, ref = pdp.plane_resize_taps(*geom), jdp.plane_resize_taps(*geom)
    if ref is None:
        assert port is None
    else:
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(pdp.identity_plane_taps(geom[-1]),
                                  jdp.identity_plane_taps(geom[-1]))


def test_fancy_upsample_and_yuv420_to_rgb_bit_exact():
    rng = np.random.default_rng(0)
    y, c = _u8(rng, (3, 2, 32, 48)), _u8(rng, (3, 2, 16, 24, 2))
    _eq(paug.fancy_upsample2x(to_torch(c[..., 0])), jaug.fancy_upsample2x(jnp.asarray(c[..., 0])))
    _eq(paug.yuv420_to_rgb(to_torch(y), to_torch(c)),
        jaug.yuv420_to_rgb(jnp.asarray(y), jnp.asarray(c)))


def _taps(rng, b, sw, sh, out):
    """Per-clip taps at a random MultiScaleCrop-like geometry (one identity)."""
    taps = []
    for i in range(b):
        if i == 0:
            taps.append(pdp.identity_plane_taps(out))
            continue
        while True:
            dw, dh = int(rng.integers(out, 2 * sw)), int(rng.integers(out, 2 * sh))
            t = pdp.plane_resize_taps(sw, sh, dw, dh, int(rng.integers(0, dw)),
                                      int(rng.integers(0, dh)), out)
            if t is not None:
                taps.append(t)
                break
    return np.stack(taps).astype(np.int32)


@pytest.mark.parametrize("channels", [False, True])
def test_resize_plane_bilinear_taps_bit_exact(channels):
    rng = np.random.default_rng(1)
    b, t, sw, sh, out = 4, 2, 40, 30, 32
    hp, wp = 48, 48  # padded stored size
    planes = _u8(rng, (b, t, hp, wp, 2) if channels else (b, t, hp, wp))
    taps = _taps(rng, b, sw, sh, out)
    ref = jax.jit(jaug.resize_plane_bilinear_taps, static_argnums=2)(
        jnp.asarray(planes), jnp.asarray(taps), out)
    _eq(paug.resize_plane_bilinear_taps(to_torch(planes), to_torch(taps), out), ref)


def test_tencrop_expand_bit_exact():
    x = _u8(np.random.default_rng(2), (2, 3, 5, 8, 10, 3))
    _eq(paug.tencrop_expand(to_torch(x)), jaug.tencrop_expand(jnp.asarray(x)))


@pytest.mark.parametrize("k", [1, 5])
def test_eval_yuv_full_crops_bit_exact(k):
    rng = np.random.default_rng(3 + k)
    b, t, ph, pw, crop = 3, 2, 48, 64, 32
    offs = np.stack([rng.integers(0, ph - crop + 1, size=(b, k)),
                     rng.integers(0, pw - crop + 1, size=(b, k))], -1).astype(np.int32)
    offs[0, 0] = (ph - crop, pw - crop)  # the far corner
    batch = {"imgs_y": _u8(rng, (b, t, ph, pw)), "imgs_c": _u8(rng, (b, t, ph // 2, pw // 2, 2)),
             f"crop_yx_{crop}": offs}
    ref = jaug.eval_yuv_full_crops({key: jnp.asarray(v) for key, v in batch.items()})
    port = paug.eval_yuv_full_crops({key: to_torch(v) for key, v in batch.items()})
    assert port.shape == (b, t, k, crop, crop, 3)
    _eq(port, ref)


@pytest.mark.parametrize("t", [3, 4])
def test_temporal_median_bit_exact(t):
    x = _u8(np.random.default_rng(5 + t), (t, 12, 16, 3))
    _eq(paug.temporal_median(to_torch(x)), jaug.temporal_median(jnp.asarray(x)))


def _boxes(rng, shape, h, w):
    """Boxes with fractional corners, some degenerate (padding) and some
    reaching the border."""
    x0 = rng.uniform(-2, w, size=shape)
    y0 = rng.uniform(-2, h, size=shape)
    boxes = np.stack([x0, y0, x0 + rng.uniform(-3, w / 2, size=shape),
                      y0 + rng.uniform(-3, h / 2, size=shape)], -1)
    boxes[..., -1, :] = 0.0  # padding
    return np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)


def test_boxes_union_mask_and_acm_composite_bit_exact():
    rng = np.random.default_rng(9)
    b, t, h, w = 3, 2, 24, 32
    ab, sb = _boxes(rng, (b, t, 3), h, w), _boxes(rng, (b, t, 3), h, w)
    _eq(paug.boxes_union_mask(to_torch(ab), h, w), jaug.boxes_union_mask(jnp.asarray(ab), h, w))
    actor, scene = _u8(rng, (b, t, h, w, 3)), _u8(rng, (b, t, h, w, 3))
    full = np.array([False, True, False])
    ref = jaug.acm_composite(jnp.asarray(actor), jnp.asarray(scene), jnp.asarray(ab),
                             jnp.asarray(sb), jnp.asarray(full), fill=127)
    _eq(paug.acm_composite(to_torch(actor), to_torch(scene), to_torch(ab), to_torch(sb),
                           to_torch(full), fill=127), ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tubemix_matches_jax_given_its_draws(seed):
    rng = np.random.default_rng(seed)
    b, m, h, w, nc = 4, 2, 16, 20, 5
    imgs = rng.standard_normal((b, m, h, w, 3)).astype(np.float32)
    targets = np.eye(nc, dtype=np.float32)[rng.integers(0, nc, size=b)]
    key = jax.random.PRNGKey(seed)
    ref_imgs, ref_t = jaug.tubemix(key, jnp.asarray(imgs), jnp.asarray(targets), 1.0, 0.5)
    draws = jax_tubemix_draws(key, b, h, w, 1.0, 0.5)
    got_imgs, got_t = paug.tubemix(to_torch(imgs), to_torch(targets), **draws)
    np.testing.assert_allclose(got_imgs.numpy(), np.asarray(ref_imgs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=0, atol=1e-6)


def test_draw_tubemix_makes_valid_draws():
    gen = torch.Generator().manual_seed(0)
    applied = 0
    for _ in range(40):
        d = paug.draw_tubemix(gen, 6, 16, 20, 1.0, 0.5)
        applied += int(d["apply"])
        assert sorted(d["perm"].tolist()) == list(range(6))
        x1, y1, x2, y2 = d["box"].tolist()
        assert 0 <= x1 <= x2 <= 20 and 0 <= y1 <= y2 <= 16
    assert 5 < applied < 35


@pytest.mark.parametrize("with_bg", [True, False])
def test_fused_train_augment_matches_jax(with_bg):
    rng = np.random.default_rng(11)
    b, m, h, w = 4, 3, 16, 24
    imgs, bg = _u8(rng, (b, m, h, w, 3)), _u8(rng, (b, h, w, 3))
    apply, flip = rng.random(b) < 0.5, rng.random(b) < 0.5
    ref = jaug.fused_train_augment(jnp.asarray(imgs), jnp.asarray(bg) if with_bg else None,
                                   jnp.asarray(apply), jnp.asarray(flip), alpha=0.3)
    got = paug.fused_train_augment(to_torch(imgs), to_torch(bg) if with_bg else None,
                                   to_torch(apply), to_torch(flip), alpha=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    alpha = rng.random(b).astype(np.float32)  # per-clip alpha
    x, y = rng.standard_normal((b, m, h, w, 3)), rng.standard_normal((b, h, w, 3))
    x, y = x.astype(np.float32), y.astype(np.float32)
    ref = jaug.background_blend(jnp.asarray(x), jnp.asarray(y), jnp.asarray(alpha),
                                jnp.asarray(apply))
    got = paug.background_blend(to_torch(x), to_torch(y), to_torch(alpha), to_torch(apply))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)

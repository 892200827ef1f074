"""The port's RandAugment (bdvcil_torch/ops/rand_augment_dev.py) against the
JAX package's, on the CPU.

  * each of the 15 ops against JAX's ``_op_*`` with the same val, sign and
    cutout centre, both signs for the geometric ops: bit for bit, except
    Rotate (at most 1% of the pixels may differ: the affine matrix's cos/sin
    come from numpy on the host, XLA's may differ by an ulp and move a
    floor) and the enhancement ops Color, Contrast, Brightness, Sharpness
    (at most 1 LSB, on at most 0.1% of the pixels: f32 blend arithmetic
    ordered or fused differently). On these inputs every op is bit for bit
    (0 pixels differ); the bounds are what the port promises.
  * ``rand_augment_batch`` against JAX's ``rand_augment_batch(keys, imgs)``:
    the draws are derived from the keys as JAX derives them
    (rand_augment_dev.py:459-465), and the keys are chosen so that the
    batches draw every op at least once. Clips that drew Rotate or an
    enhancement op are held to the bounds above; every other clip bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.ops import rand_augment_dev as jra
from bdvcil_torch.ops import rand_augment_dev as pra
from tests.torch_port_helpers import jax_randaug_draws

ENHANCE = (5, 6, 7, 8)  # Color, Contrast, Brightness, Sharpness
ROTATE_FRACTION, ENHANCE_FRACTION = 1e-2, 1e-3


def _img(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, size=3)
    return np.clip(base[None, None] + rng.integers(0, 56, size=(h, w, 3)), 0, 255).astype(np.uint8)


def _clip(seed, t=2, h=48, w=64):
    return np.stack([_img(seed * 10 + i, h, w) for i in range(t)])


def _narrow_clip(seed, t=2, h=48, w=64):
    """Frames whose levels span a random narrow range per channel: AutoContrast
    then scales by 255 / span, which is inexact in f32."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 150, size=(t, 1, 1, 3))
    span = rng.integers(20, 90, size=(t, 1, 1, 3))
    return (lo + rng.integers(0, 1 << 16, size=(t, h, w, 3)) % (span + 1)).astype(np.uint8)


def _check(op, got, ref, what):
    diff = np.abs(got.astype(np.int32) - np.asarray(ref).astype(np.int32))
    n_off = int((diff.max(axis=-1) > 0).sum())  # pixels with any channel off
    pixels = diff[..., 0].size
    if op == pra.ROTATE:
        assert n_off <= ROTATE_FRACTION * pixels, f"{what}: {n_off} of {pixels} pixels differ"
    elif op in ENHANCE:
        assert diff.max() <= 1, f"{what}: off by {diff.max()}"
        assert n_off <= ENHANCE_FRACTION * pixels, f"{what}: {n_off} of {pixels} pixels differ"
    else:
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


CASES = [(op, False) for op in range(pra.NUM_OPS)] + [(op, True) for op in pra.GEO_IDS]


@pytest.mark.parametrize("op,sign", CASES, ids=lambda v: str(v))
def test_each_op_matches_jax(op, sign):
    assert pra.OP_TABLE == jra.OP_TABLE
    loc = (20.3, 11.7)
    for k, clip in enumerate((_clip(op), _narrow_clip(op))):
        for m in (5, 10, 27):
            val = pra.op_magnitudes(m)[op]
            assert val == jra.op_magnitudes(m)[op]
            ref = jra._OPS[op](jnp.asarray(clip), jnp.float32(val), jnp.bool_(sign),
                               tuple(map(jnp.float32, loc)))
            got = pra.apply_op(op, torch.from_numpy(clip)[None], val, [sign], [loc[0]], [loc[1]])
            _check(op, got[0].numpy(), ref, f"{pra.OP_TABLE[op][0]} sign={sign} m={m} clip {k}")


def _covering_batches(b, n, h, w, seed=0):
    """Batches of raw uint32 keys (as the loaders ship them) that together
    draw every op at least once."""
    pool = np.random.default_rng(seed).integers(0, 2**32, size=(256, 2), dtype=np.uint32)
    ops = jax_randaug_draws(pool, n, h, w)[0]
    missing, chosen = set(range(pra.NUM_OPS)), []
    while missing:
        best = max(range(len(pool)), key=lambda i: len(missing & set(ops[i].tolist())))
        chosen.append(best)
        missing -= set(ops[best].tolist())
    chosen += [i for i in range(len(pool)) if i not in chosen][: -len(chosen) % b]
    return [pool[chosen[i:i + b]] for i in range(0, len(chosen), b)]


def test_rand_augment_batch_matches_jax_with_every_op_drawn():
    b, t, h, w, n, m = 4, 3, 48, 64, 2, 10
    batches = _covering_batches(b, n, h, w)
    drawn = set()
    for i, keys in enumerate(batches):
        imgs = np.stack([_clip(100 + 7 * i + j, t, h, w) for j in range(b)])
        ref = np.asarray(jra.rand_augment_batch(jnp.asarray(keys), jnp.asarray(imgs), n=n, m=m))
        ops, sign, x0, y0 = jax_randaug_draws(keys, n, h, w)
        drawn |= set(ops.ravel().tolist())
        got = pra.rand_augment_batch(torch.from_numpy(imgs), torch.from_numpy(ops.astype(np.int64)),
                                     torch.from_numpy(sign), torch.from_numpy(x0),
                                     torch.from_numpy(y0), m=m).numpy()
        for j in range(b):
            loose = [op for op in ops[j] if op == pra.ROTATE or op in ENHANCE]
            _check(loose[0] if loose else 0, got[j], ref[j], f"batch {i} clip {j} ops {ops[j]}")
    assert drawn == set(range(pra.NUM_OPS))


def test_rand_augment_batch_rows_and_input_untouched():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(np.stack([_clip(j, 2, 32, 40) for j in range(4)]))
    keep = imgs.clone()
    draws = pra.draw_randaug(torch.Generator().manual_seed(0), 4, 2, 32, 40)
    rows = torch.from_numpy(rng.random(4) < 0.5)
    rows[0], rows[1] = True, False
    out = pra.rand_augment_batch(imgs, *(draws[k] for k in pra.DRAW_KEYS), rows=rows)
    full = pra.rand_augment_batch(imgs, *(draws[k] for k in pra.DRAW_KEYS))
    assert torch.equal(imgs, keep)
    for j in range(4):
        assert torch.equal(out[j], full[j] if rows[j] else imgs[j])
    none = pra.rand_augment_batch(imgs, *(draws[k] for k in pra.DRAW_KEYS),
                                  rows=torch.zeros(4, dtype=torch.bool))
    assert none is imgs
    one = pra.rand_augment_clip(imgs[2], draws["randaug_op_indices"][2].numpy(),
                                bool(draws["randaug_flip_sign"][2]),
                                float(draws["randaug_x0"][2]), float(draws["randaug_y0"][2]))
    assert torch.equal(one, full[2])


def test_draw_randaug_ranges():
    d = pra.draw_randaug(torch.Generator().manual_seed(1), 64, 2, 32, 48)
    assert d["randaug_op_indices"].shape == (64, 2)
    assert int(d["randaug_op_indices"].min()) >= 0
    assert int(d["randaug_op_indices"].max()) < pra.NUM_OPS
    assert d["randaug_flip_sign"].dtype == torch.bool
    assert 0 <= float(d["randaug_x0"].min()) and float(d["randaug_x0"].max()) < 48
    assert 0 <= float(d["randaug_y0"].min()) and float(d["randaug_y0"].max()) < 32
    assert all(v.device.type == "cpu" for v in d.values())

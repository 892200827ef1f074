"""The port's input functions (bdvcil_torch/data/device_pipeline.py) against
the JAX package's, on the CPU, on one synthetic wire batch per case.

The batch (``bdvcil_torch.data.synthetic.wire_batch``, B = 4, T = 3, crops of
32 px, planes stored at 44 x 36 padded to 48 x 48) goes to JAX with a
``randaug_key`` per clip and to the port with the draws JAX derives from that
key (rand_augment_dev.py:459-465). ``make_fast_input_fn`` for each wire
format with and without RandAugment and BGMix, ``make_fast_acm_input_fn``
for each wire format; the f32 and the bf16 outputs bit for bit, except on
clips that drew Rotate or an enhancement op, where the bounds of
tests/test_torch_port_rand_augment.py hold (at most 1% of the pixels, and
for the enhancement ops at most 1 LSB / 57.12 in normalized units on 0.1%).
On these batches those clips are bit for bit as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.data import device_pipeline as jdp
from bdvcil_torch.data import device_pipeline as pdp
from bdvcil_torch.data.synthetic import wire_batch
from bdvcil_torch.ops import rand_augment_dev as pra
from tests.torch_port_helpers import jax_randaug_draws

B, T, S, STORED = 4, 3, 32, (44, 36)
ENHANCE = (5, 6, 7, 8)
LSB = 1.0 / 57.12 + 1e-6  # one uint8 level after the normalize, at the smallest std


def _batches(wire_format, seed, **kw):
    """(JAX batch, port batch): the same pixels and masks; JAX gets keys, the
    port the draws derived from them."""
    port = wire_batch(wire_format, B, T, S, seed=seed, stored=STORED, **kw)
    keys = np.random.default_rng(seed + 100).integers(0, 2**32, size=(B, 2), dtype=np.uint32)
    ops, sign, x0, y0 = jax_randaug_draws(keys, 2, S, S)
    port.update(randaug_op_indices=ops.astype(np.int64), randaug_flip_sign=sign,
                randaug_x0=x0, randaug_y0=y0)
    jbatch = {k: jnp.asarray(v) for k, v in port.items() if k not in pra.DRAW_KEYS}
    jbatch["randaug_key"] = jnp.asarray(keys)
    return jbatch, pdp.batch_to_device(port, "cpu"), ops


def _check(got, ref, ops, randaugmented, what):
    """Bit for bit but on clips whose RandAugment drew Rotate or an
    enhancement op; those within the stated bounds."""
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape, what
    for j in range(got.shape[0]):
        drawn = set(ops[j].tolist()) if randaugmented[j] else set()
        diff = np.abs(got[j] - ref[j])
        if drawn & ({pra.ROTATE} | set(ENHANCE)):
            n_off = int((diff.max(axis=-1) > 0).sum())
            frac = 1e-2 if pra.ROTATE in drawn else 1e-3
            assert n_off <= frac * diff[..., 0].size, f"{what} clip {j}: {n_off} pixels differ"
            if pra.ROTATE not in drawn:
                assert diff.max() <= LSB * 1.01, f"{what} clip {j}: off by {diff.max()}"
        else:
            np.testing.assert_array_equal(got[j], ref[j], err_msg=f"{what} clip {j}")


MODES = [(True, True), (False, True), (True, False), (False, False)]


@pytest.mark.parametrize("wire_format", pdp.WIRE_FORMATS)
@pytest.mark.parametrize("with_randaug,with_bgmix", MODES,
                         ids=["randaug+bgmix", "bgmix", "randaug", "plain"])
def test_fast_input_fn_matches_jax(wire_format, with_randaug, with_bgmix):
    seed = 7 * MODES.index((with_randaug, with_bgmix)) + pdp.WIRE_FORMATS.index(wire_format)
    jbatch, batch, ops = _batches(wire_format, seed, with_bg=with_bgmix)
    randaugmented = batch["apply_randaug"].numpy() & with_randaug
    for jdtype, dtype in ((jnp.float32, None), (jnp.bfloat16, torch.bfloat16)):
        kw = dict(alpha=0.5, with_randaug=with_randaug, with_bgmix=with_bgmix,
                  wire_format=wire_format)
        ref = jax.jit(jdp.make_fast_input_fn(dtype=jdtype, **kw))(jbatch)
        got = pdp.make_fast_input_fn(dtype=dtype, **kw)(batch)
        assert got.dtype == (dtype or torch.float32)
        _check(got, ref, ops, randaugmented, f"{wire_format} {dtype}")


@pytest.mark.parametrize("wire_format", pdp.WIRE_FORMATS)
def test_fast_acm_input_fn_matches_jax(wire_format):
    jbatch, batch, ops = _batches(wire_format, 40 + pdp.WIRE_FORMATS.index(wire_format), acm=True)
    assert batch["apply_acm"].any() and not batch["apply_acm"].all()
    # JAX's bf16 output is its f32 normalize cast to bf16 (normalize_batch);
    # the cast is taken here because XLA:CPU crashes compiling the bf16 program
    ref = jax.jit(jdp.make_fast_acm_input_fn(wire_format=wire_format))(jbatch)
    for jdtype, dtype in ((jnp.float32, None), (jnp.bfloat16, torch.bfloat16)):
        got = pdp.make_fast_acm_input_fn(dtype=dtype, wire_format=wire_format)(batch)
        assert got.dtype == (dtype or torch.float32)
        _check(got, ref.astype(jdtype), ops, batch["apply_randaug"].numpy(),
               f"acm {wire_format} {dtype}")


def test_input_fn_refuses_draws_on_a_device_and_a_wrong_n():
    _, batch, _ = _batches("rgb", 3)
    fn = pdp.make_fast_input_fn(randaug_n=3)
    with pytest.raises(ValueError, match="randaug_n"):
        fn(batch)
    with pytest.raises(ValueError, match="unknown wire_format"):
        pdp.make_fast_input_fn(wire_format="auto")
    meta = dict(batch, randaug_op_indices=batch["randaug_op_indices"].to("meta"))
    with pytest.raises(ValueError, match="host"):
        pdp.make_fast_input_fn()(meta)

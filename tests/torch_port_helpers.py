"""Shared set-up for the tests that hold bdvcil_torch against bdvcil_tpu.

Inputs and weights are made with numpy and handed to both sides; the JAX
package's variables go to the port through ``models/convert.py``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import importlib
import pathlib
import tempfile

import jax
import numpy as np
import pytest
import torch

from bdvcil_torch.models.convert import from_jax_variables

T = 2
BLOCK_PREFIX = "backbone.layer1.0."

# (JAX backbone switches, port backbone switches) for configurations A and B
CONFIGS = {
    "A": (dict(shift_mode="pad", conv1x1_mode="pallas_stats_interpret"),
          dict(shift_mode="pad", conv1x1_mode="pallas_stats")),
    "B": (dict(shift_mode="fused_block", conv1x1_mode="xla"),
          dict(shift_mode="fused_block", conv1x1_mode="xla")),
}


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def randomize_bn(variables, seed: int):
    """Non-trivial BN affine and running statistics, so eval-mode BN is pinned."""
    rng = np.random.default_rng(seed)
    out = numpy_tree(variables)

    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict):
                walk(v, stats.get(k, {}) if stats is not None else None)
            elif k == "scale":
                params[k] = (rng.random(v.shape) + 0.5).astype(np.float32)
            elif k == "bias" and stats:
                params[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        if stats and "mean" in stats:
            stats["mean"] = (rng.standard_normal(stats["mean"].shape) * 0.5).astype(np.float32)
            stats["var"] = (rng.random(stats["var"].shape) + 0.5).astype(np.float32)

    walk(out["params"], out.get("batch_stats", {}))
    return out


def block_state_dict(block_vars):
    """A JAX block's {'params', 'batch_stats'} -> the port block's state_dict."""
    wrapped = {c: {"backbone": {"layer1_0": v}} for c, v in block_vars.items()}
    return {k[len(BLOCK_PREFIX):]: v for k, v in from_jax_variables(wrapped).items()}


def model_cfg(depth: int, shift_mode: str, conv1x1_mode: str, num_classes: int,
              classifier: str = "LocalSimilarityClassifier", in_channels: int = 2048):
    loss = dict(type="LSCLoss") if classifier == "LocalSimilarityClassifier" else dict(
        type="CrossEntropyLoss")
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=depth, num_segments=T, shift_div=8,
                      shift_mode=shift_mode, conv1x1_mode=conv1x1_mode),
        cls_head=dict(
            type="IncrementalTSMHead", num_classes=num_classes, in_channels=in_channels,
            inc_head_config=dict(type=classifier, out_features=num_classes, nb_proxies=1),
            num_segments=T, loss_cls=loss, dropout_ratio=0.0,
        ),
        test_cfg=dict(average_clips="prob"),
    )


def jax_native():
    """``bdvcil_tpu.data.native`` with its decoder loaded.

    The JAX package builds ``native/libbdvcdec.so`` with an unlocked ``make``
    that writes the library in place, and a process that loses the race
    (``ctypes.CDLL`` on a half-written file) keeps ``available()`` False for
    its lifetime. Every test worker collects the JAX files whose ``skipif``
    runs that build, so a worker can lose. Here the processes take turns
    under a file lock; a module that has failed runs the build once more and
    is reloaded, which clears its flag, and tries again. Fixtures run after
    every worker has collected, so no collection-time build is still writing.
    """
    from bdvcil_tpu.data import native

    with open(pathlib.Path(tempfile.gettempdir()) / "bdvcil_tpu_native_build.lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        if native.available():
            return native
        built = native._build()
        native = importlib.reload(native)
        if native.available():
            return native
        try:
            ctypes.CDLL(str(native._LIB_PATH))
            reason = "the library loads but the module still reports it unavailable"
        except OSError as e:
            reason = str(e)
        pytest.fail(f"the JAX package's native decoder did not build or load on a second try "
                    f"(make {'succeeded' if built else 'failed'}): {reason}")


def assert_batch_matches_jax(port, ref, crop: int, n: int = 2):
    """Every key of a JAX loader's batch equal in the port loader's, bit for
    bit, ``randaug_key`` as the ``n`` RandAugment draws the port derives from
    it at ``crop``."""
    from bdvcil_torch.data import loaders
    from bdvcil_torch.ops.rand_augment_dev import DRAW_KEYS

    assert set(port) == (set(ref) - {"randaug_key"}) | set(DRAW_KEYS)
    for key, want in ref.items():
        if key == "randaug_key":
            continue
        got = port[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    draws = loaders.randaug_draws_from_keys(ref["randaug_key"], n, crop, crop)
    for key in DRAW_KEYS:
        np.testing.assert_array_equal(port[key], draws[key], err_msg=key)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def jax_randaug_draws(keys, n: int, h: int, w: int):
    """The per-clip RandAugment draws the JAX package derives from raw uint32
    keys (bdvcil_tpu/ops/rand_augment_dev.py:459-465), as numpy arrays:
    op_indices (B, n) int64, flip_sign (B,) bool, x0, y0 (B,) f32."""
    return [np.array(a) for a in _jax_draws(jax.numpy.asarray(keys), n, h, w)]


@functools.partial(jax.jit, static_argnames=("n", "h", "w"))
def _jax_draws(keys, n, h, w):
    def clip_params(key):
        k_ops, k_sign, k_x, k_y = jax.random.split(key, 4)
        op_indices = jax.random.randint(k_ops, (n,), 0, 15)
        flip_sign = jax.random.uniform(k_sign) > 0.5
        x0 = jax.random.uniform(k_x, (), minval=0.0, maxval=float(w))
        y0 = jax.random.uniform(k_y, (), minval=0.0, maxval=float(h))
        return op_indices.astype(jax.numpy.int32), flip_sign, x0, y0

    return jax.vmap(clip_params)(keys)


def jax_tubemix_draws(key, b: int, h: int, w: int, alpha: float, prob: float):
    """The draws JAX's tubemix makes from ``key`` (bdvcil_tpu/ops/augment.py:
    198-203, 170-179), in the form the port's ``tubemix`` takes them."""
    from bdvcil_tpu.ops.augment import rand_bbox

    k_apply, k_perm, k_beta, k_box = jax.random.split(key, 4)
    apply = jax.random.uniform(k_apply) > 1.0 - prob
    perm = jax.random.permutation(k_perm, b)
    lam0 = jax.random.beta(k_beta, alpha, alpha)
    box = rand_bbox(k_box, h, w, lam0)
    return dict(apply=torch.tensor(bool(apply)), perm=torch.from_numpy(np.array(perm)),
                box=torch.tensor([int(v) for v in box]))


def grow_like_jax(model, jtree, nc0: int, nc1: int):
    """The port's update_fc to ``nc1`` classes, then the grown rows copied from
    the JAX variables ``jtree`` (numpy leaves), so both sides hold the same head."""
    from bdvcil_torch.models import update_fc

    update_fc(model, nc1, torch.Generator().manual_seed(0))
    ref = from_jax_variables(jtree)
    with torch.no_grad():
        for name, p in model.cls_head.named_parameters():
            if p.shape[0] == nc1:
                p[nc0:] = ref[f"cls_head.{name}"][nc0:]

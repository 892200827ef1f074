"""The port's driver entry points (bdvcil_torch/graft_entry.py) against the JAX
system's (``__graft_entry__.py``), on the CPU.

  * ``_model_cfg`` equals JAX's for both calls the JAX file makes.
  * ``entry(device="cpu")``'s forward against JAX's ``entry()`` forward at
    JAX's weights converted, on one clip of the ones input and one seeded
    numpy clip (8 frames at 224², bf16): cls_score within 3e-2 of the largest
    |logit|, the bf16 tolerance of ``chip_smoke.py`` phase 3.
  * ``dryrun_multichip(2, device="cpu")``, two gloo rank processes, against
    the JAX dry run's calls composed here on ``jax.devices()[:2]`` at the same
    initial weights (JAX's, converted), the same dropout masks (JAX's
    ``bernoulli`` returns the port's, ``graft_entry.dropout_masks``, one a
    step key) and the same RandAugment draws (the port takes the draws JAX
    derives from the dry run's ``randaug_key``s). Tolerances of
    ``tests/test_torch_port_distributed.py``: a first step's losses rtol 1e-5,
    a later step's 1e-4; the eval scores atol 1e-5; the input functions'
    outputs as ``tests/test_torch_port_input_fn.py`` holds them (bit for bit
    but on clips that drew Rotate or an enhancement op).

Both entry points raise without a CUDA device and without ``device``:
``tests/test_torch_port_rules.py`` holds that rule for every entry point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from bdvcil_torch import graft_entry
from bdvcil_torch.models import from_jax_variables
from bdvcil_torch.ops import rand_augment_dev as pra
from tests.torch_port_helpers import jax_native, jax_randaug_draws, numpy_tree

N = 2
LOGIT_TOL = 3e-2  # of the largest |logit|: bf16 (chip_smoke.py phase 3)
# The dry run's frames are constant, so the untrained R18's BatchNorms at
# 2x2 and 1x1 normalize nearly equal rows, and f32 rounding grows into the
# losses: each package's f32 dry run lies up to 4.5e-3 (a first step's loss)
# and 1.52e-2 (the KD term; the second step of (b)) from its own float64
# one. The f32 losses are held to JAX's, and to the float64 truth, just above
# that stray; the float64 witness holds the two packages' math within
# WITNESS_RTOL (measured 2e-11 to 8.8e-8 on a first step, 1.6e-6 on (b)'s
# second step after an update, where JAX's f32 KD term feeds the gradient).
F32_RTOL = 1e-2
F32_CHAOTIC_RTOL = 2e-2
WITNESS_RTOL = 1e-6
WITNESS_LATER_RTOL = 1e-5
EVAL_ATOL = 1e-5  # the gathered eval scores (test_torch_port_distributed.py)
ENHANCE = (5, 6, 7, 8)
LSB = 1.0 / 57.12 + 1e-6  # one uint8 level after the normalize (test_torch_port_input_fn.py)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("args", [(51, 50, 8), (5, 18, 2)])
def test_model_cfg_matches_jax(args):
    assert graft_entry._model_cfg(*args) == jax_graft._model_cfg(*args)


def test_entry_forward_matches_jax():
    jfn, (jvars, jimgs) = jax_graft.entry()
    fn, (model, imgs) = graft_entry.entry(device="cpu")
    assert imgs.shape == jimgs.shape == (8, 8, 224, 224, 3) and imgs.dtype == torch.float32
    assert imgs.device.type == "cpu" and bool((imgs == 1).all())
    model.load_state_dict(from_jax_variables(numpy_tree(jvars)))
    rng = np.random.default_rng(0)
    clips = np.concatenate([np.ones((1, 8, 224, 224, 3), np.float32),
                            rng.standard_normal((1, 8, 224, 224, 3)).astype(np.float32)])
    want = np.asarray(jax.jit(jfn)(jvars, jnp.asarray(clips)).astype(jnp.float32))
    got = fn(model, torch.from_numpy(clips)).float().numpy()
    assert got.shape == want.shape == (2, 1, 51)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"entry: max abs err {err:.3g} of max |logit| {np.abs(want).max():.3g}")
    assert err <= LOGIT_TOL * np.abs(want).max()


# --- the dry run ----------------------------------------------------------------


class KeyedMasks:
    """JAX's ``bernoulli`` for flax's dropout, returning the port's masks:
    the first step key seen takes the first mask of the queue, the next new
    key the next one; a key seen again (another device) its own mask."""

    def __init__(self):
        self.queue, self.by_key = [], {}

    def load(self, masks):
        self.queue, self.by_key = list(masks), {}

    def host(self, key):
        k = np.asarray(key).tobytes()
        if k not in self.by_key:
            self.by_key[k] = self.queue.pop(0)
        return self.by_key[k]

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def bernoulli(self, key, p, shape):
        del p
        if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
            key = jax.random.key_data(key)
        return jax.pure_callback(self.host, jax.ShapeDtypeStruct(tuple(shape), jnp.bool_), key)


def jax_dry_run(n, variables, masks, native, dtype=jnp.float32):
    """The JAX dry run's parts (__graft_entry__.py:82-363) on ``n`` devices in
    ``dtype``: {part: loss (and kd), the eval scores, the input functions'
    outputs}. Under x64 the eval part is left out: JAX's yuv420_full crop
    mixes int64 and int32 offsets there and does not trace."""
    from bdvcil_tpu.data.device_pipeline import (identity_plane_taps, make_fast_acm_input_fn,
                                                 make_fast_input_fn, plane_resize_taps,
                                                 resolve_wire_format)
    from bdvcil_tpu.models import build_model
    from bdvcil_tpu.optim import build_optimizer
    from bdvcil_tpu.parallel import make_mesh, replicate, shard_batch
    from bdvcil_tpu.runtime import (TrainState, make_eval_step, make_multi_train_step,
                                    make_train_step)

    mesh = make_mesh(jax.devices()[:n])
    t = 2
    spec = build_model(jax_graft._model_cfg(num_classes=5, depth=18, num_segments=t),
                       dtype=dtype)
    variables = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
    # the JAX dry run's own settings (__graft_entry__.py:96-118)
    tx = build_optimizer(
        variables["params"],
        dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
             paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.01, momentum=0.9,
             weight_decay=1e-4),
        dict(type="MultiStepLR", params=dict(milestones=[20, 30], gamma=0.1)),
        steps_per_epoch=4, grad_clip=1.0, accumulate_steps=1)
    kd = dict(module_names=["backbone.layer1", "backbone.layer4", "cls_head.avg_pool"],
              module_weights=[0.01, 0.01, 0.01], scale_factor=3.3, exemplar_only=False)
    out = {}

    def fresh():
        return replicate(TrainState.create(jax.tree.map(jnp.copy, variables), tx), mesh)

    prev = replicate(jax.tree.map(jnp.copy, variables), mesh)
    masks.load(graft_entry.dropout_masks(n)["a"])
    step = make_train_step(spec, tx, num_classes=5, method="base", task_idx=1,
                           prev_num_classes=3, kd_config=kd, donate=False)
    put = shard_batch({"imgs": np.ones((n, t, 16, 16, 3), dtype),
                       "label": np.zeros((n, 1), np.int64)}, mesh)
    _, m = step(fresh(), prev, put["imgs"], put["label"], {}, jax.random.PRNGKey(0))
    out["a"] = dict(loss=float(m["loss"]), kd_loss=float(m["kd_loss"]))

    masks.load(graft_entry.dropout_masks(n)["b"])
    mstep = make_multi_train_step(dict(spec=spec, tx=tx, num_classes=5, method="base",
                                       task_idx=1, prev_num_classes=3, kd_config=kd), 2)
    mb = shard_batch({"imgs": np.ones((2, n, t, 16, 16, 3), dtype),
                      "label": np.zeros((2, n, 1), np.int64)}, mesh, leading_pytree_axes=1)
    _, m = mstep(fresh(), prev, mb["imgs"], mb["label"], {},
                 jax.random.split(jax.random.PRNGKey(5), 2))
    out["b"] = dict(loss=float(m["loss"]))

    if dtype == jnp.float32:
        eb = shard_batch({"imgs_y": np.full((n, t, 32, 32), 128, np.uint8),
                          "imgs_c": np.full((n, t, 16, 16, 2), 128, np.uint8),
                          "crop_yx_16": np.zeros((n, 5, 2), np.int32)}, mesh)
        out["c"] = dict(cls_score=np.asarray(
            make_eval_step(spec, 5)(replicate(variables, mesh), eb)["cls_score"]))

    wire = resolve_wire_format("auto", 16)
    keys = np.arange(2 * n, dtype=np.uint32).reshape(n, 2)
    common = dict(flip=np.zeros(n, bool), randaug_key=keys)
    if wire == "yuv420":
        pix = dict(imgs_y=np.full((n, t, 16, 16), 128, np.uint8),
                   imgs_c=np.full((n, t, 8, 8, 2), 128, np.uint8),
                   bg_y=np.full((n, 16, 16), 64, np.uint8),
                   bg_c=np.full((n, 8, 8, 2), 128, np.uint8))
        apix = dict(imgs_y=pix["imgs_y"], imgs_c=pix["imgs_c"],
                    scene_y=np.full((n, t, 16, 16), 64, np.uint8),
                    scene_c=np.full((n, t, 8, 8, 2), 128, np.uint8))
    else:
        pix = dict(imgs_u8=np.full((n, t, 16, 16, 3), 128, np.uint8),
                   bg_u8=np.full((n, 16, 16, 3), 64, np.uint8))
        apix = dict(imgs_u8=pix["imgs_u8"], scene_u8=np.full((n, t, 16, 16, 3), 64, np.uint8))
    acm = dict(actor_boxes=np.tile(np.array([2.0, 2.0, 10.0, 12.0], np.float32), (n, t, 1, 1)),
               scene_boxes=np.tile(np.array([1.0, 1.0, 8.0, 8.0], np.float32), (n, t, 1, 1)),
               actor_full_mask=np.zeros(n, bool), apply_acm=np.ones(n, bool),
               apply_randaug=np.zeros(n, bool), actor_flip=np.zeros(n, bool),
               scene_flip=np.zeros(n, bool), randaug_key=keys)
    taps = np.tile(plane_resize_taps(32, 24, 40, 30, 4, 2, 16), (n, 1, 1))
    ctaps = np.tile(plane_resize_taps(16, 12, 20, 15, 2, 1, 8), (n, 1, 1))
    ty = np.tile(identity_plane_taps(16)[None], (n, 1, 1))
    tc = np.tile(identity_plane_taps(8)[None], (n, 1, 1))
    planes = native.has_fetch_planes() and native.has_yuv420()
    parts = dict(
        d=(make_fast_input_fn(alpha=0.5, with_randaug=True, wire_format=wire),
           dict(pix, apply_bgmix=np.zeros(n, bool), apply_randaug=np.ones(n, bool), **common),
           jax.random.PRNGKey(1)),
        f=(make_fast_acm_input_fn(wire_format=wire), dict(apix, **acm), jax.random.PRNGKey(2)))
    if planes:
        parts["e"] = (
            make_fast_input_fn(alpha=0.5, with_randaug=True, wire_format="planes"),
            dict(imgs_y=np.full((n, t, 24, 32), 128, np.uint8),
                 imgs_c=np.full((n, t, 12, 16, 2), 128, np.uint8),
                 bg_y=np.full((n, 24, 32), 64, np.uint8),
                 bg_c=np.full((n, 12, 16, 2), 128, np.uint8), imgs_taps_y=taps,
                 imgs_taps_c=ctaps, bg_taps_y=taps, bg_taps_c=ctaps,
                 apply_bgmix=np.ones(n, bool), apply_randaug=np.zeros(n, bool), **common),
            jax.random.PRNGKey(3))
        parts["g"] = (
            make_fast_acm_input_fn(wire_format="planes"),
            dict(imgs_y=np.full((n, t, 32, 32), 128, np.uint8),
                 imgs_c=np.full((n, t, 16, 16, 2), 128, np.uint8),
                 scene_y=np.full((n, t, 32, 32), 64, np.uint8),
                 scene_c=np.full((n, t, 16, 16, 2), 128, np.uint8), imgs_taps_y=ty,
                 imgs_taps_c=tc, scene_taps_y=ty, scene_taps_c=tc, **acm),
            jax.random.PRNGKey(4))
    for part, (input_fn, pixels, key) in parts.items():
        masks.load(graft_entry.dropout_masks(n)[part])
        fstep = make_train_step(spec, tx, num_classes=5, method="base", task_idx=0,
                                donate=False, input_fn=input_fn)
        batch = shard_batch(dict(pixels, label=np.zeros((n, 1), np.int64)), mesh)
        label = batch.pop("label")
        _, m = fstep(fresh(), None, batch, label, {}, key)
        clips = jax.jit(input_fn)({k: jnp.asarray(v) for k, v in pixels.items()})
        out[part] = dict(loss=float(m["loss"]), input=np.asarray(clips.astype(jnp.float32)))
    return wire, planes, keys, out


class _F64:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX norm's
    explicit f32 statistics in f64, for the witness."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _draws(keys):
    ops, sign, x0, y0 = jax_randaug_draws(keys, 2, 16, 16)
    return dict(zip(pra.DRAW_KEYS, (ops.astype(np.int64), sign, x0.astype(np.float32),
                                    y0.astype(np.float32))))


@pytest.fixture(scope="module")
def dry_runs():
    """The JAX dry run in f32 on two devices and its x64 witness; the port's
    two gloo ranks in f32 and its one-process float64 witness; all from JAX's
    init, the port's dropout masks and JAX's RandAugment draws."""
    import flax.linen.stochastic as stochastic
    from bdvcil_tpu.models import build_model, init_model_params
    from bdvcil_tpu.models import norm as jax_norm

    native = jax_native()
    spec = build_model(jax_graft._model_cfg(num_classes=5, depth=18, num_segments=2))
    variables = numpy_tree(init_model_params(spec, jax.random.PRNGKey(0), (1, 2, 16, 16, 3)))
    weights = from_jax_variables(variables)
    masks = KeyedMasks()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stochastic, "random", masks)
        wire, planes, keys, want = jax_dry_run(N, variables, masks, native)
        mp.setattr(jax_norm, "jnp", _F64())
        with jax.enable_x64(True):
            _, _, _, want64 = jax_dry_run(N, variables, masks, native, jnp.float64)
            draws64 = _draws(keys)
    draws = _draws(keys)
    got = graft_entry.dryrun_multichip(N, device="cpu", weights=weights, randaug_draws=draws)
    with pytest.MonkeyPatch.context() as mp:
        cast32 = torch.Tensor.float
        mp.setattr(torch.Tensor, "float", lambda t, *a, **k: t if t.dtype == torch.float64
                   else cast32(t, *a, **k))
        got64 = graft_entry._run_parts(dict(n=N, wire=got["wire"], planes=got["planes"], seed=0,
                                            weights=weights, draws=draws64,
                                            dtype=torch.float64), torch.device("cpu"))
    return dict(got=got, want=want, got64=got64, want64=want64, wire=wire, planes=planes,
                ops=draws["randaug_op_indices"])


def test_dry_run_ranks_and_wires(dry_runs):
    got = dry_runs["got"]
    assert got["n"] == N and got["device"] == "cpu" and got["backend"] == "gloo"
    assert got["wire"] == dry_runs["wire"], "the two packages' decoders give other wires"
    planes = ["dryrun_multichip fast-input (planes)", "dryrun_multichip fast-acm (planes)"]
    want = [f"dryrun_multichip({N})", "dryrun_multichip K-dispatch (K=2)",
            "dryrun_multichip eval yuv-full wire", f"dryrun_multichip fast-input ({got['wire']})",
            planes[0], f"dryrun_multichip fast-acm ({got['wire']})", planes[1]]
    if not got["planes"]:
        want = [w for w in want if w not in planes]
    assert [line.split(" ok:")[0] for line in got["lines"]] == want


def _losses_match(runs, part, key, f32_rtol, witness_rtol):
    got, want = runs["got"][part][key], runs["want"][part][key]
    got64, want64 = runs["got64"][part][key], runs["want64"][part][key]
    assert np.isfinite([got, want, got64, want64]).all()
    np.testing.assert_allclose(got64, want64, rtol=witness_rtol)
    np.testing.assert_allclose(got, want, rtol=f32_rtol)
    np.testing.assert_allclose(got, want64, rtol=f32_rtol)


def test_dry_run_kd_step_matches_jax(dry_runs):
    assert dry_runs["want"]["a"]["kd_loss"] > 0
    _losses_match(dry_runs, "a", "loss", F32_RTOL, WITNESS_RTOL)
    _losses_match(dry_runs, "a", "kd_loss", F32_CHAOTIC_RTOL, WITNESS_RTOL)


def test_dry_run_k_dispatch_matches_jax(dry_runs):
    # the metrics of the second inner step: the first step's update is in it
    _losses_match(dry_runs, "b", "loss", F32_CHAOTIC_RTOL, WITNESS_LATER_RTOL)


def test_dry_run_eval_scores_match_jax(dry_runs):
    got, want = dry_runs["got"]["c"]["cls_score"], dry_runs["want"]["c"]["cls_score"]
    assert got.shape == want.shape == (N, 10, 5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_ATOL)


def _check_clips(got, want, ops, randaugmented, what):
    """``tests/test_torch_port_input_fn.py``'s rule: bit for bit but on clips
    whose RandAugment drew Rotate or an enhancement op."""
    assert got.shape == want.shape, what
    for j in range(got.shape[0]):
        drawn = set(ops[j].tolist()) if randaugmented else set()
        diff = np.abs(got[j] - want[j])
        if drawn & {pra.ROTATE, *ENHANCE}:
            n_off = int((diff.max(axis=-1) > 0).sum())
            frac = 1e-2 if pra.ROTATE in drawn else 1e-3
            assert n_off <= frac * diff[..., 0].size, f"{what} clip {j}: {n_off} pixels differ"
            if pra.ROTATE not in drawn:
                assert diff.max() <= LSB * 1.01, f"{what} clip {j}: off by {diff.max()}"
        else:
            assert diff.max() == 0, f"{what} clip {j}: off by {diff.max()}"


@pytest.mark.parametrize("part", ["d", "e", "f", "g"])
def test_dry_run_input_parts_match_jax(dry_runs, part):
    got, want = dry_runs["got"][part], dry_runs["want"].get(part)
    if part in "eg" and not (dry_runs["planes"] and dry_runs["got"]["planes"]):
        pytest.skip(f"the planes wire: JAX's decoder has it {dry_runs['planes']}, the "
                    f"port's {dry_runs['got']['planes']}")
    _check_clips(got["input"], want["input"], dry_runs["ops"], part == "d", f"part {part}")
    # the witness's draws are those JAX derives from the keys under x64
    np.testing.assert_array_equal(dry_runs["got64"][part]["input"],
                                  dry_runs["want64"][part]["input"])
    if part == "d":
        # RandAugment on constant frames: the draws must have moved some pixel
        assert (got["input"].std(axis=(1, 2, 3)) > 0).any()
    _losses_match(dry_runs, part, "loss", F32_RTOL, WITNESS_RTOL)

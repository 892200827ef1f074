"""The port's eval path against the JAX package's, on the CPU, f32.

  * ``make_eval_step`` on a float batch, 5-D uint8 centre crops, 6-D uint8
    TenCrop and the ``yuv420_full`` wire (centre and TenCrop), R18 and R50,
    4 segments, 56² crops, from the same converted weights (non-trivial BN
    statistics): cls_score and repr within rtol 1e-4, atol 1e-4, and every
    repr row of norm 1;
  * the same in configuration B (``shift_mode='fused_block'``: the port's
    plain version of #1 against JAX's fused block epilogue);
  * ``make_multi_eval_step`` with K = 2 equals two single calls bit for bit;
  * ``run_inference`` over a ragged loader (a short last batch, padded to
    ``pad_batch_to``) with K = 2 against JAX's: the same rows in the same
    order, labels equal, scores and repr within the tolerance above; and
    the same result for K = 1;
  * ``FastEvalLoader`` batches (rgb centre, rgb TenCrop, yuv420_full
    TenCrop) equal JAX's bit for bit on a corpus written by
    ``data/corpus.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_torch.data import corpus, native
from bdvcil_torch.data.loaders import FastEvalLoader
from bdvcil_torch.models import build_model, from_jax_variables
from bdvcil_torch.runtime import make_eval_step, make_multi_eval_step
from bdvcil_torch.runtime.loops import run_inference
from bdvcil_tpu.data.device_pipeline import FastEvalLoader as JaxFastEvalLoader
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.runtime import make_eval_step as jax_make_eval_step
from bdvcil_tpu.runtime import make_multi_eval_step as jax_make_multi_eval_step
from bdvcil_tpu.runtime.loops import run_inference as jax_run_inference
from tests.torch_port_helpers import CONFIGS, jax_native, randomize_bn

SEG, HW, NC = 4, 56, 5
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(depth: int, switches: dict):
    in_ch = 512 if depth < 50 else 2048
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=depth, num_segments=SEG, shift_div=8, **switches),
        cls_head=dict(type="IncrementalTSMHead", num_classes=NC, in_channels=in_ch,
                      inc_head_config=dict(type="LocalSimilarityClassifier", out_features=NC,
                                           nb_proxies=1),
                      num_segments=SEG, loss_cls=dict(type="LSCLoss"), dropout_ratio=0.5),
        test_cfg=dict(average_clips="prob"),
    )


def pair(depth: int, config: str = "default"):
    """(JAX spec, JAX variables, port spec, port module) with the same weights."""
    jsw, psw = CONFIGS[config] if config != "default" else ({}, {})
    jspec = jax_build_model(cfg(depth, jsw))
    jvars = randomize_bn(jax_init(jspec, jax.random.PRNGKey(depth), (1, SEG, HW, HW, 3)), depth)
    spec = build_model(cfg(depth, psw), device="cpu")
    module = spec.module(NC)
    module.load_state_dict(from_jax_variables(jvars))
    return jspec, jvars, spec, module


@pytest.fixture(scope="module")
def models():
    return {(d, c): pair(d, c) for d, c in ((18, "default"), (50, "default"), (18, "B"))}


def inputs(kind: str, b: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "float":
        return rng.standard_normal((b, SEG, HW, HW, 3)).astype(np.float32)
    if kind == "u8":
        return rng.integers(0, 256, (b, SEG, HW, HW, 3), dtype=np.uint8)
    if kind == "tencrop":
        return rng.integers(0, 256, (b, SEG, 5, HW, HW, 3), dtype=np.uint8)
    k = 5 if kind == "yuv_tencrop" else 1
    ph, pw = 64, 80
    offs = np.stack([rng.integers(0, [ph - HW + 1, pw - HW + 1], size=(k, 2)) for _ in range(b)])
    return {"imgs_y": rng.integers(0, 256, (b, SEG, ph, pw), dtype=np.uint8),
            "imgs_c": rng.integers(0, 256, (b, SEG, ph // 2, pw // 2, 2), dtype=np.uint8),
            f"crop_yx_{HW}": offs.astype(np.int32)}


def to_port(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(v) for k, v in x.items()}
    return torch.from_numpy(x)


def assert_outputs_match(out, ref):
    for key in ("cls_score", "repr"):
        np.testing.assert_allclose(np.asarray(out[key]), np.asarray(ref[key]), err_msg=key, **TOL)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(out["repr"]), axis=-1), 1.0, rtol=1e-5)


KINDS = ["float", "u8", "tencrop", "yuv_center", "yuv_tencrop"]


@pytest.mark.parametrize("depth,config,kind",
                         [(18, "default", k) for k in KINDS] + [(50, "default", k) for k in KINDS]
                         + [(18, "B", "float"), (18, "B", "yuv_tencrop")])
def test_eval_step_matches_jax(models, depth, config, kind):
    jspec, jvars, spec, module = models[(depth, config)]
    x = inputs(kind)
    ref = jax_make_eval_step(jspec, NC)(jvars, jax.tree.map(jnp.asarray, x))
    out = make_eval_step(spec, NC)(module, to_port(x))
    groups = 10 if "tencrop" in kind else 1
    assert tuple(out["cls_score"].shape) == (2, groups, NC)
    assert_outputs_match({k: v.numpy() for k, v in out.items()}, ref)


def test_multi_eval_step_equals_single_calls_bit_for_bit(models):
    _, _, spec, module = models[(18, "default")]
    xs = [inputs("yuv_tencrop", seed=s) for s in (1, 2)]
    stacked = {k: torch.stack([to_port(x)[k] for x in xs]) for k in xs[0]}
    multi = make_multi_eval_step(spec, NC, 2)(module, stacked)
    single = make_eval_step(spec, NC)
    for k, x in enumerate(xs):
        one = single(module, to_port(x))
        for key in ("cls_score", "repr"):
            assert torch.equal(multi[key][k], one[key]), key


def test_eval_step_refuses_another_width(models):
    _, _, spec, module = models[(18, "default")]
    with pytest.raises(ValueError, match="classes"):
        make_eval_step(spec, NC + 1)(module, to_port(inputs("float")))


class ListLoader:
    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("k", [1, 2])
def test_run_inference_matches_jax(models, k):
    jspec, jvars, spec, module = models[(18, "default")]
    rng = np.random.default_rng(5)
    sizes = [3, 3, 3, 3, 3, 1]  # a ragged last batch, and a ragged last K-group for K = 2
    batches = [{"imgs": rng.standard_normal((n, SEG, HW, HW, 3)).astype(np.float32),
                "label": rng.integers(0, NC, (n, 1))} for n in sizes]
    ref = jax_run_inference(jax_make_eval_step(jspec, NC), jvars, ListLoader(batches, 3),
                            extract_repr=True, pad_batch_to=3, steps_per_dispatch=k,
                            multi_eval_step=jax_make_multi_eval_step(jspec, NC, k))
    out = run_inference(make_eval_step(spec, NC), module, ListLoader(batches, 3), device="cpu",
                        extract_repr=True, pad_batch_to=3, steps_per_dispatch=k,
                        multi_eval_step=make_multi_eval_step(spec, NC, k) if k > 1 else None)
    assert out["cls_score"].shape == (sum(sizes), 1, NC)
    np.testing.assert_array_equal(out["labels"], np.concatenate([b["label"] for b in batches])[:, 0])
    np.testing.assert_array_equal(out["labels"], np.asarray(ref["labels"]))
    assert_outputs_match(out, ref)


@pytest.fixture(scope="module")
def corpus_infos(tmp_path_factory):
    if not native.available():
        pytest.fail(f"the port's native decoder did not build: {native.build_error()}")
    jax_native()  # the JAX loaders decode with it
    infos, _ = corpus.write_corpus(tmp_path_factory.mktemp("eval_corpus"), 5,
                                   frames_per_video=8, seed=2, num_classes=3, size=(100, 76))
    return infos


@pytest.mark.parametrize("tencrop,wire", [(False, "rgb"), (True, "rgb"), (True, "yuv420_full"),
                                          (True, "auto")])
def test_fast_eval_loader_matches_jax(corpus_infos, tencrop, wire):
    kw = dict(batch_size=2, num_segments=SEG, crop_size=HW, short_side=64, tencrop=tencrop,
              wire_format=wire, process_index=0, process_count=1)
    port = FastEvalLoader(corpus_infos, **kw)
    ref = JaxFastEvalLoader(corpus_infos, **kw)
    assert port.wire_format == ref.wire_format and len(port) == len(ref) == 3
    got, want = list(port), list(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)

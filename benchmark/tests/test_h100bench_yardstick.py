"""The yardstick's arithmetic: FLOPs of a clip, the kernels' least times,
the trace's busy time and gaps."""

import pytest

from benchmark import flops, tracing


def test_r50_train_flops_of_a_clip():
    assert flops.train_flops_per_clip(50) == pytest.approx(0.1962e12, rel=1e-3)
    assert flops.train_flops_per_clip(50) == 196182540288.0


def test_r50_matches_the_programs_roofline():
    from bdvcil_torch import roofline

    assert flops.train_flops_per_clip(50, 8, 224) == roofline.train_flops_per_clip(8, 224)
    assert flops.train_flops_per_clip(50, 8, 256) == roofline.train_flops_per_clip(8, 256)


def test_r34_by_hand_per_stage():
    # multiply-adds of one 224² frame, stage by stage
    stem = 112 * 112 * 64 * 3 * 49
    s1 = 3 * 2 * (56 * 56 * 64 * 64 * 9)
    s2 = 28 * 28 * 128 * 64 * 9 + 7 * 28 * 28 * 128 * 128 * 9 + 28 * 28 * 128 * 64
    s3 = 14 * 14 * 256 * 128 * 9 + 11 * 14 * 14 * 256 * 256 * 9 + 14 * 14 * 256 * 128
    s4 = 7 * 7 * 512 * 256 * 9 + 5 * 7 * 7 * 512 * 512 * 9 + 7 * 7 * 512 * 256
    assert flops.forward_macs_per_frame(34) == stem + s1 + s2 + s3 + s4
    assert flops.train_flops_per_clip(34) == 6 * 8 * (stem + s1 + s2 + s3 + s4)
    assert flops.train_flops_per_clip(34) / flops.train_flops_per_clip(50) == pytest.approx(
        0.89, abs=0.01)


def test_stats_gemm_shapes_of_r50():
    shapes = flops.stats_gemm_shapes(50, 192)
    assert len(shapes) == 32
    assert shapes[0] == (192 * 56 * 56, 64, 64) and shapes[1] == (192 * 56 * 56, 64, 256)
    assert shapes[-1] == (192 * 7 * 7, 512, 2048)
    assert flops.stats_gemm_shapes(34, 192) == []
    m, k, n = shapes[1]
    assert flops.stats_gemm_least_seconds(50, 192) > (2 * (m * k + m * n + k * n)) / 3.35e12


def test_fused_shift_least_seconds():
    elems = flops.block_output_elements(34, 384)
    assert len(elems) == 16 and elems[0] == 384 * 56 * 56 * 64
    assert flops.fused_shift_least_seconds(34, 384) == pytest.approx(
        sum(2 * 8 * n for n in elems) / 3.35e12)


def test_busy_union_and_gaps():
    iv = [(0, 10), (5, 12), (20, 30), (29, 31), (40, 41)]
    assert tracing.busy_us(iv) == 12 + 11 + 1
    assert tracing.idle_gaps(iv, 0, 50) == [(12, 20), (31, 40), (41, 50)]
    ops = [("bench.step", 0, 35), ("aten::conv", 10, 15), ("aten::copy_", 36, 45)]
    named = dict(tracing.named_gaps(tracing.idle_gaps(iv, 0, 50), ops))
    assert named == pytest.approx({"aten::conv": 8e-6, "bench.step": 9e-6, "aten::copy_": 9e-6})
    assert tracing.named_gaps([(50, 60)], [("x", 0, 1)]) == [["outside any host op", 10e-6]]
    kern = [("k1", 0, 10), ("k2", 10, 30), ("k1", 40, 45)]
    top = tracing.top_device_ops(kern)
    assert [n for n, _ in top] == ["k2", "k1"]
    assert [s for _, s in top] == pytest.approx([20e-6, 15e-6])


def test_the_corpus_is_written_once_from_its_traffic_file(tmp_path):
    import cv2
    import numpy as np

    from benchmark import corpus

    traffic = dict(corpus_seed=3, train_videos_per_class=2, frames=4, width=80, height=60,
                   quality=95)
    splits = [[4, 1], [0], [2, 3]]
    root = corpus.write_corpus(tmp_path / "c", traffic, splits, "train.txt", "val.txt", threads=2)
    train = (root / "train.txt").read_text().split("\n")[:-1]
    assert train[0] == "c004_v0000 4 4" and len(train) == 4
    assert len((root / "val.txt").read_text().split("\n")[:-1]) == 5
    frame = cv2.imread(str(root / "rawframes" / "c001_v0001" / "img_00004.jpg"))
    assert frame.shape == (60, 80, 3) and frame.std() > 5  # structured, not flat
    assert (root / "bg_extract" / "val_c003.jpg").exists()
    before = (root / "corpus.json").stat().st_mtime_ns
    corpus.write_corpus(root, traffic, splits, "train.txt", "val.txt", threads=2)
    assert (root / "corpus.json").stat().st_mtime_ns == before  # reused, not rewritten
    a, b = (corpus.video_frames(np.random.default_rng([3, 0]), 4, 80, 60) for _ in range(2))
    assert (a == b).all()

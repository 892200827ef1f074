"""``python -m bdvcil_torch.profile_e2e`` (the port of ``tools/profile_e2e.py``)
on the CPU, at TSM-R18, 2 segments of 32², batch 2, 2 steps a mode.

  * each mode prints, after the warm-up note, one JSON line with the JAX
    tool's keys (``tools/profile_e2e.py:127-146``): the stages, which lie
    inside the mode's wall time, ``put`` and ``device`` only in
    ``baseline``; with ``BDVC_PROFILE_PRODUCER=1`` the producer's four phase
    means and the plane cache's counters with their hit rate;
  * with the switch off, or from ``--source synthetic``, no producer phases;
  * without ``--device`` and without a card it refuses to run.
"""

import json

import pytest
import torch

from bdvcil_torch import profile_e2e
from bdvcil_torch.data import loaders

# the JAX tool's keys of a mode's line (tools/profile_e2e.py:127-129, 133-146)
JAX_KEYS = {"mode", "steps", "wall_s", "clips_per_sec", "wait", "put", "dispatch", "device"}
PRODUCER_KEYS = {"producer_ms", "decode_cache"}
STAGES = ("wait", "put", "dispatch", "device")
SMALL = ["2", "--device", "cpu", "--depth", "18", "--size", "32", "--segments", "2",
         "--batch", "2", "--videos", "4", "--frames", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("profile_corpus"))


def lines_of(capsys, argv):
    assert profile_e2e.main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("mode", profile_e2e.MODES)
def test_each_mode_prints_jax_keys_and_the_producer_phases(corpus_dir, capsys, monkeypatch,
                                                           mode):
    monkeypatch.setenv("BDVC_PROFILE_PRODUCER", "1")
    note, line = lines_of(capsys, SMALL + ["--mode", mode, "--corpus", corpus_dir])
    assert note["note"] == "warm" and note["device"] == "cpu" and note["source"] == "jpeg"
    assert JAX_KEYS | PRODUCER_KEYS <= set(line)
    assert line["mode"] == mode and line["steps"] == 2
    assert line["clips_per_sec"] == pytest.approx(2 * 2 / line["wall_s"])
    assert all(line[k] >= 0 for k in STAGES)
    assert sum(line[k] for k in STAGES) <= line["wall_s"] * 1000 / 2
    if mode != "baseline":
        assert line["put"] == line["device"] == 0
    assert set(line["producer_ms"]) == {"pass1", "probe", "pass2", "decode"}
    assert all(v >= 0 for v in line["producer_ms"].values())
    assert line["producer_batches"] >= 2
    cache = line["decode_cache"]
    assert cache["hit_rate"] == pytest.approx(cache["hits"] / (cache["hits"] + cache["misses"]))
    assert loaders.PRODUCER_STATS == {}  # read and cleared


def test_all_modes_without_the_switch_or_the_decoder(corpus_dir, capsys, monkeypatch):
    monkeypatch.setenv("BDVC_PROFILE_PRODUCER", "0")
    for source in ("jpeg", "synthetic"):
        lines = lines_of(capsys, SMALL + ["--corpus", corpus_dir, "--source", source])
        assert [line.get("mode") for line in lines] == [None, *profile_e2e.MODES]
        for line in lines[1:]:
            assert set(line) == JAX_KEYS
        assert loaders.PRODUCER_STATS == {}


def test_it_refuses_the_cpu_unless_asked(corpus_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_e2e.main([a for a in SMALL if a not in ("--device", "cpu")]
                         + ["--source", "synthetic"])

"""``--profile``'s device trace and several cards in one ``preprocess``, on
the CPU:

* ``python -m stamp_tpu_torch --profile train`` on a small cohort writes a
  ``torch.profiler`` Chrome trace under ``<output_dir>/profile/`` whose
  events name the training stages, and the stage table in the log; its
  ``model.ckpt`` and ``metrics.csv`` equal a run without ``--profile``,
  bitwise.  A fleet's rank names its trace ``rank{r}``; a profiler that
  cannot start leaves a warning and the stage table, one that records no
  CUDA activity where it was asked for leaves the CPU trace and a warning;
  ``stage_table`` alone times the stages without a trace.
* ``preprocess`` with ``device: cuda`` and the visible card count patched
  to 2 (this process only) launches two local ranks of the same command,
  each taking its ``shard_worklist`` share of the slides (the ranks here
  run the command's CPU copy: this machine has no card); with one card, a
  CPU device or a fleet already set, it runs in the process.
"""

import json
import logging

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from stamp_tpu_torch import __main__ as cli
from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
from stamp_tpu_torch.parallel import _fleet_launch, distributed
from stamp_tpu_torch.utils import profiling
from test_torch_distributed import _features, _preprocess_config, _write_slides
from test_torch_train import _cohort, _train_config, stamp_logger_handlers  # noqa: F401 (fixture)


def test_profile_writes_a_trace_and_leaves_the_outputs_alone(tmp_path, stamp_logger_handlers):  # noqa: F811
    cohort = _cohort(tmp_path, "classification")
    runs = {}
    for name, flags in (("plain", []), ("profiled", ["--profile"])):
        config = _train_config(tmp_path, name, "classification", cohort, use_alibi=True, bag_size=8)
        cli.main(["-c", config, *flags, "train"])
        runs[name] = tmp_path / name
    trace = runs["profiled"] / "profile" / "stamp.pt.trace.json"
    assert trace.is_file() and not (runs["plain"] / "profile").exists()
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train/step", "train/eval"} <= names  # the stages are ranges of the trace
    assert any(e.get("cat") == "cpu_op" for e in events)
    log = (runs["profiled"] / "logfile.log").read_text()
    assert "profile — per-stage wall time" in log and "train/step" in log and f"writing a CPU trace to {trace}" in log
    got, want = (load_checkpoint(runs[n] / "model.ckpt") for n in ("profiled", "plain"))
    for key, value in want["variables"].items():
        for leaf, array in _leaves(value, key):
            np.testing.assert_array_equal(dict(_leaves(got["variables"][key], key))[leaf], array, err_msg=leaf)
    metrics = [pd.read_csv(runs[n] / "lightning_logs/version_0/metrics.csv") for n in ("profiled", "plain")]
    pd.testing.assert_frame_equal(*metrics)


def _leaves(tree, prefix: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_trace_names_the_rank_in_a_fleet(monkeypatch, tmp_path):
    assert profiling.trace_name() == "stamp"
    monkeypatch.setenv("STAMP_NUM_PROCESSES", "2")
    monkeypatch.setenv("STAMP_PROCESS_ID", "1")
    assert profiling.trace_name() == "rank1"
    with profiling.profiled_run(tmp_path):
        with profiling.stage("work"):
            torch.ones(3).sum()
    assert (tmp_path / "profile" / "rank1.pt.trace.json").is_file()


def test_profile_without_a_working_profiler_keeps_the_stage_table(monkeypatch, tmp_path, caplog):
    def refuse(*args, **kwargs):
        raise RuntimeError("no profiler on this machine")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with caplog.at_level(logging.INFO, logger="stamp"):
        with profiling.profiled_run(tmp_path):
            with profiling.stage("work"):
                pass
    assert "device tracing unavailable (RuntimeError: no profiler on this machine); stage timing only" in caplog.text
    assert "profile — per-stage wall time" in caplog.text and "work" in caplog.text
    assert not (tmp_path / "profile").exists()


def test_a_cuda_trace_without_device_activity_says_so(tmp_path, caplog):
    """Asked for CUDA activity where the profiler records none (no card
    visible to PyTorch), the trace keeps the CPU side and the stage
    ranges, and the log carries the profiler's own warning and ours."""
    with caplog.at_level(logging.INFO, logger="stamp"):
        with profiling.profiled_run(tmp_path, cuda=True):
            with profiling.stage("work"):
                torch.ones(3).sum()
    assert "torch.profiler: CUDA is not available" in caplog.text
    assert "the trace recorded no CUDA activity" in caplog.text
    events = json.loads((tmp_path / "profile" / "stamp.pt.trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events) and any(e.get("name") == "work" for e in events)


def test_stage_table_alone_writes_no_trace(caplog):
    with caplog.at_level(logging.INFO, logger="stamp"):
        with profiling.stage_table():
            with profiling.stage("work"):
                pass
    assert "profile — per-stage wall time" in caplog.text and "work" in caplog.text
    assert profiling.timer.calls["work"] == 1 and not profiling.timer.enabled
    assert "trace" not in caplog.text


def _cards(monkeypatch, n: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("cards,device,fleet,ranks", [
    (2, "cuda", False, 2), (4, "auto", False, 4), (1, "cuda", False, 0), (2, "cpu", False, 0), (2, "cuda:1", False, 0),
    (2, "cuda", True, 0),
])  # fmt: skip
def test_preprocess_ranks_follow_the_cards(monkeypatch, cards, device, fleet, ranks):
    _cards(monkeypatch, cards)
    for key in ("STAMP_COORDINATOR_ADDRESS", "STAMP_NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    if fleet:
        monkeypatch.setenv("STAMP_NUM_PROCESSES", "2")
    assert cli._card_ranks(device) == ranks


def test_preprocess_spreads_over_two_cards(tmp_path, monkeypatch, stamp_logger_handlers):  # noqa: F811
    """The command launches two local ranks with its own arguments; each
    extracts its ``shard_worklist`` share, together every slide once."""
    paths = _write_slides(tmp_path / "slides")
    config = _preprocess_config(tmp_path, tmp_path / "slides", tmp_path / "out")
    body = yaml.safe_load(config.read_text())
    body["preprocessing"]["device"] = "cuda"
    config.write_text(yaml.safe_dump(body))
    cpu_config = tmp_path / "cpu.yaml"  # the ranks' copy: this machine has no card
    cpu_config.write_text(yaml.safe_dump(body | {"preprocessing": body["preprocessing"] | {"device": "cpu"}}))
    for key in ("STAMP_COORDINATOR_ADDRESS", "STAMP_NUM_PROCESSES", "STAMP_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, value in {"STAMP_RANDOM_WEIGHTS": "1", "STAMP_EXTRACT_BATCH": "16", "HOME": str(tmp_path)}.items():
        monkeypatch.setenv(key, value)
    _cards(monkeypatch, 2)
    launched = []
    real_launch = _fleet_launch.launch_fleet

    def launch(argv, *, n_processes, **kwargs):
        launched.append((list(argv), n_processes, kwargs))
        argv = [str(cpu_config) if a == str(config) else a for a in argv]
        return real_launch(argv, n_processes=n_processes, timeout=300, env_extra={"OMP_NUM_THREADS": "1"})

    monkeypatch.setattr(_fleet_launch, "launch_fleet", launch)
    cli.main(["-c", str(config), "preprocess"])
    assert launched == [(["-m", "stamp_tpu_torch", "-c", str(config), "preprocess"], 2, {"capture": False})]
    assert sorted(_features(tmp_path / "out")) == sorted(p.stem for p in paths)
    log = (tmp_path / "out" / "logfile.log").read_text()
    assert "2 cards: running this command as 2 local ranks" in log
    for rank in range(2):
        share = distributed.shard_worklist(paths, index=rank, count=2)
        assert f"extraction fleet: process {rank}/2 takes {len(share)} slides" in log

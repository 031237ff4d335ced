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


# --- the program's spans and counters ---------------------------------------------


@pytest.fixture
def recording():
    """The stage timer on, its sums and ring empty; off again afterwards."""
    profiling.timer.reset()
    profiling.timer.enabled = True
    try:
        yield profiling.timer
    finally:
        profiling.timer.enabled = False
        profiling.timer.reset()


def _spans(name: str | None = None) -> list[profiling.Span]:
    return [r for r in profiling.records() if isinstance(r, profiling.Span) and name in (None, r.name)]


def _counts(name: str) -> list[int]:
    return [r.n for r in profiling.records() if isinstance(r, profiling.Count) and r.name == name]


def test_spans_record_their_parent_times_and_self_time(recording):
    import threading
    import time

    def nest(tag: str) -> None:
        with profiling.stage(f"{tag}/outer"):
            time.sleep(0.002)
            with profiling.stage(f"{tag}/inner"):
                time.sleep(0.004)
            with profiling.stage(f"{tag}/inner"):
                pass

    other = threading.Thread(target=nest, args=("thread",))
    with profiling.stage("main/top"):  # open while the other thread nests: no span of that thread is its child
        other.start()
        nest("main")
        other.join(timeout=30)
    assert not other.is_alive()
    by_index = {s.index: s for s in _spans()}
    (top,) = _spans("main/top")
    for tag, root_parent in (("main", top.index), ("thread", None)):
        (outer,) = _spans(f"{tag}/outer")
        inner = _spans(f"{tag}/inner")
        assert outer.parent == root_parent and [s.parent for s in inner] == [outer.index] * 2
        root = top.index if tag == "main" else outer.index
        assert outer.root == root and all(s.root == root for s in inner)
        assert len({outer.thread, *(s.thread for s in inner)}) == 1
        assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns for s in inner)
        assert inner[0].end_ns - inner[0].start_ns >= 4_000_000 and inner[0].self_ns == inner[0].end_ns - inner[0].start_ns
        children = sum(s.end_ns - s.start_ns for s in inner)
        assert outer.self_ns == outer.end_ns - outer.start_ns - children and outer.self_ns >= 2_000_000
    assert _spans("thread/outer")[0].thread != top.thread
    assert by_index[top.index].self_ns == top.end_ns - top.start_ns - sum(
        s.end_ns - s.start_ns for s in _spans("main/outer"))  # fmt: skip
    assert recording.calls["main/inner"] == 2 and recording.calls["thread/outer"] == 1


def test_counts_add_up(recording):
    for n in (3, 4, 5):
        profiling.count("tiles", n)
    assert _counts("tiles") == [3, 4, 5] and recording.counts["tiles"] == 12
    times = [r.time_ns for r in profiling.records()]
    assert times == sorted(times)
    assert "tiles" in recording.report() and "12" in recording.report()


def test_the_stage_table_shares_self_time(recording):
    import time

    with profiling.stage("outer"):
        time.sleep(0.01)
        with profiling.stage("inner"):
            time.sleep(0.02)
    lines = recording.report().splitlines()
    assert lines[0].split() == ["stage", "calls", "total", "s", "self", "s", "share"]
    shares = {line.split()[0]: float(line.split()[-1].rstrip("%")) for line in lines[1:]}
    assert sum(shares.values()) == pytest.approx(100.0, abs=0.2) and shares["inner"] > shares["outer"]
    assert recording.self_seconds["outer"] < recording.seconds["outer"]


def test_the_ring_keeps_its_bound():
    timer = profiling.StageTimer(ring=4)
    timer.enabled = True
    for i in range(10):
        with timer.stage(f"s{i}"):
            pass
    timer.count("c", 1)
    assert [getattr(r, "name") for r in timer.records()] == ["s7", "s8", "s9", "c"]
    assert sum(timer.calls.values()) == 10 and timer.counts["c"] == 1


def test_program_spans_share_the_profiler_clock():
    """Under ``torch.profiler`` each span is a range of the trace, and its
    times lie within 50 µs of the range's (the profiler's host clock is
    ``time.time_ns()``'s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):  # the first range of a process sets the profiler up
        with profiling.stage("warm-up"):
            pass
    profiling.timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording() and not profiling.timer.enabled
        for i in range(20):
            with profiling.stage(f"clock/{i}"):
                torch.ones(64).sum()
    spans = {s.name: s for s in _spans() if s.name.startswith("clock/")}
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() in spans}  # fmt: skip
    assert set(ranges) == set(spans)
    for name, span in spans.items():
        assert abs(span.start_ns - ranges[name].start_ns()) <= 50_000, name
        assert abs(span.end_ns - ranges[name].end_ns()) <= 50_000, name
    profiling.timer.reset()
    assert not profiling.recording()


def _tiny_extractor(monkeypatch, int8: bool):
    from stamp_tpu_torch.models import vit_image
    from stamp_tpu_torch.preprocessing.extractor import make_vit_extractor

    monkeypatch.setitem(vit_image.VIT_CONFIGS, "test-tiny", vit_image.ViTConfig(
        patch_size=32, embed_dim=64, depth=1, num_heads=2))  # fmt: skip
    monkeypatch.setenv("STAMP_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("STAMP_EXTRACT_BATCH", "4")
    if int8:
        monkeypatch.setenv("STAMP_INT8_EXTRACTION", "1")
    else:
        monkeypatch.delenv("STAMP_INT8_EXTRACTION", raising=False)
    return make_vit_extractor(identifier="test-tiny", arch="test-tiny", device=torch.device("cpu"))


def _tiny_step():
    """A tiny whole-slide training step (the MIL ViT, AdamW, one cycle) as
    ``_train_model_impl`` builds it, and one bag of 5 tiles padded to 8."""
    from stamp_tpu_torch.modeling.tasks import LitTileClassifier
    from stamp_tpu_torch.modeling.train import forward_batch
    from stamp_tpu_torch.models.vision_transformer import VisionTransformer
    from stamp_tpu_torch.parallel.mesh import make_dp_train_step

    task = LitTileClassifier(
        model_class=VisionTransformer, ground_truth_label="label", categories=["a", "b"],
        category_weights=np.array([0.5, 0.5], dtype=np.float32), dim_input=8, total_steps=10, max_lr=1e-4,
        div_factor=25.0, dim_model=16, dim_feedforward=16, n_heads=2, n_layers=1, dropout=0.0, use_alibi=False,
    )  # fmt: skip
    cpu = torch.device("cpu")
    optimizer = task.make_optimizer(task.module.parameters())
    step = make_dp_train_step(task, optimizer, None, schedule=task.lr_schedule(),
                              forward=lambda batch, key_mask, group: forward_batch(
                                  task, batch, key_mask, cpu, train=True, group=group))  # fmt: skip
    bags = np.zeros((1, 8, 8), dtype=np.float32)
    bags[0, :5] = np.random.default_rng(0).normal(size=(5, 8))
    batch = (bags, np.zeros((1, 8, 2), dtype=np.float32), np.array([5]), torch.tensor([[1.0, 0.0]]))
    return step, batch, np.arange(8)[None] < 5


def test_no_profiler_and_no_timer_record_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    profiling.timer.reset()
    assert not profiling.recording()
    extractor = _tiny_extractor(monkeypatch, int8=False)
    extractor.forward(np.zeros((3, 224, 224, 3), dtype=np.uint8))
    step, batch, key_mask = _tiny_step()
    step(batch, key_mask, 0)
    assert profiling.records() == [] and not profiling.timer.calls and not profiling.timer.counts and opened == []


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_the_extractor_forward_is_spanned(monkeypatch, recording, int8):
    extractor = _tiny_extractor(monkeypatch, int8)
    batch = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    for call in range(2):
        recording.reset()
        extractor.forward(batch)
        (forward,) = _spans("extract/forward")
        children = [s for s in _spans() if s.parent == forward.index]
        want = ["extract/upload", "extract/normalize"] + (["extract/calibrate"] if int8 and call == 0 else [])
        assert [s.name for s in children] == want + ["extract/tower"], call
        assert all(s.root == forward.index for s in children) and forward.parent is None
        assert forward.self_ns == forward.end_ns - forward.start_ns - sum(s.end_ns - s.start_ns for s in children)


def test_the_training_step_is_spanned_and_counts_its_rows(recording):
    step, batch, key_mask = _tiny_step()
    step(batch, key_mask, 0)
    (top,) = _spans("train/step")
    children = [s.name for s in _spans() if s.parent == top.index]
    assert children == ["train/forward", "train/loss", "train/backward", "train/optimizer"]  # no mesh, no all-reduce
    assert _counts("train/tiles") == [5] and _counts("train/rows") == [8]

"""The spatial-ALiBi cell (``mil_vit_alibi.train.wholeslide20x``): found and
loaded by the harness with its driver, limits and metric readers; its
blocked reference against a dense form of itself; its control and planted
faults read ``correct`` false at tiny widths on the CPU; its readers'
arithmetic against counts made by hand."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import peaks, spec
from benchmark.harness.runner import run_cell
from benchmark.harness.trace import OpCall
from benchmark.reference import mil_vit_alibi as reference

from conftest import tiny_cell

CELL = "mil_vit_alibi.train.wholeslide20x"
NEW_METRICS = ("mfu_pct.train_alibi", "flash_alibi_mha_roofline", "flash_alibi_mha_bwd_roofline",
               "alibi_pair_sums_roofline", "alibi_stats_ms_per_step.train")  # fmt: skip
H100 = peaks.card_peaks("NVIDIA H100 80GB HBM3")


def test_the_cell_is_found_with_its_files():
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.driver_name == "train_alibi"
    assert cell.config["use_alibi"] and cell.config["reduced"] == []
    assert (cell.config["dim_model"], cell.config["n_heads"], cell.config["n_layers"]) == (512, 8, 2)
    assert (cell.traffic["tiles_min"], cell.traffic["tiles_max"], cell.traffic["bag_size"]) == (8400, 48000, None)
    assert [m["name"] for m in cell.end_to_end] == ["train_tiles_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert set(NEW_METRICS) <= set(names) and "mfu_pct.train" not in names
    assert {"host_ms_per_step.train", "idle_pct.train", "loss_ms_per_step.train", "valid_rows_pct.train"} <= set(names)
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert hasattr(spec.driver(cell), "Session")
    for name in NEW_METRICS:
        assert callable(spec.metric_reader(cell, name).read)


def _attention_inputs(t=300, heads=4, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(heads, t, d, generator=g, requires_grad=True) for _ in range(3))
    coords = torch.randint(0, 30, (t, 2), generator=g).float() * 224.0
    coords[0] = 0.0  # the class token
    dist_scale = (torch.rand(heads, generator=g) / 3000.0).requires_grad_(True)
    return q, k, v, coords, dist_scale


def test_blocked_attention_matches_its_dense_form():
    """At T = 300 the blocked attention (blocks of 64 queries, recomputed in
    the backward) and the dense one ([H, T, T] at once) give the same output
    and gradients to float32's rounding (1e-5 of the largest)."""
    q, k, v, coords, scale = _attention_inputs()
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    results = []
    for block in (64, None):
        out = reference.attention(q, k, v, coords, scale, block)
        results.append((out.detach(), *torch.autograd.grad(out, (q, k, v, scale), do)))
    for got, want in zip(*results):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_blocked_training_steps_match_the_dense_ones():
    """Two training steps of the tiny cell's model through the reference,
    blocked and dense: the same losses, gradients and buffers."""
    from benchmark.drivers import train_alibi

    cell = tiny_cell(CELL)
    c = cell.config
    module = train_alibi.train._names_module(SimpleNamespace(config=c))
    state = train_alibi.initial_state(module, c, 3, torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    batches = [(torch.randn(1, n, c["dim_input"], generator=g),
                torch.randint(0, 30, (1, n, 2), generator=g).float() * 224.0, torch.eye(2)[[i % 2]], 512)
               for i, n in enumerate((299, 180))]  # fmt: skip
    schedule = {"total_steps": 10, "max_lr": 1e-4, "div_factor": 25.0}
    weights = torch.tensor([0.5, 0.5])
    blocked, dense = (reference.train(state, batches, weights, c, schedule, generator=torch.Generator().manual_seed(5),
                                      block=block) for block in (64, None))  # fmt: skip
    assert blocked["losses"] == pytest.approx(dense["losses"], rel=1e-6)
    for got, want in zip(blocked["grads"], dense["grads"]):
        largest = max(float(w.abs().max()) for w in want.values())  # a key's bias has a gradient of rounding alone
        for k in want:
            assert float((got[k] - want[k]).abs().max()) <= 1e-5 * max(float(want[k].abs().max()), 1e-3 * largest), k
    for k in dense["buffers"]:
        assert torch.equal(blocked["buffers"][k], dense["buffers"][k])
    assert float(dense["buffers"]["block_0.mhsa.items_so_far"][0]) == 3.0


@pytest.mark.parametrize(("planted", "correct"), [
    ({}, True), ({"control": True}, False), ({"fault": "welford_skipped"}, False),
    ({"fault": "padded_rows"}, False), ({"fault": "answer_altered"}, False), ({"fault": "update_scaled"}, False),
])  # fmt: skip
def test_correct(planted, correct):
    result = run_cell(tiny_cell(CELL), 2**31 + 23, 0.3, False, torch.device("cpu"), time.perf_counter(), **planted)
    assert result["correct"] is correct, result["checks"]


def test_a_traced_run_reads_the_programs_span():
    """On the CPU the traced run reads the statistic's span (the card's
    peaks, and so the rooflines and MFU, are unknown there)."""
    result = run_cell(tiny_cell(CELL), 2**31 + 29, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["alibi_stats_ms_per_step.train"]["value"] > 0.0


def _reader(name):
    return spec.metric_reader(spec.cell(CELL), name)


def test_flash_rooflines_count_as_the_kernel_table():
    """Rows 6 and 7–8 at [8, 16385, 64] with 60% of the keys valid and a
    dense dO: PERF.md's bounds, 1.666 and 2.666 ms."""
    bh, t, d = 8, 16385, 64
    valid = torch.tensor(bh * int(0.6 * t))
    fwd = _reader("flash_alibi_mha_roofline").least_seconds({"bh": bh, "tq": t, "tk": t, "d": d, "valid_keys": valid},
                                                            H100)  # fmt: skip
    bwd = _reader("flash_alibi_mha_bwd_roofline").least_seconds({"bh": bh, "tq": t, "tk": t, "d": d,
                                                                 "pairs": valid * t}, H100)  # fmt: skip
    assert fwd == pytest.approx(1.666e-3, rel=1e-3) and bwd == pytest.approx(2.666e-3, rel=1e-3)


def test_pair_sums_roofline_and_mfu_by_hand():
    calls = [OpCall(info={"rows": 65537, "keys": 65537}, device_s=1e-3)]
    pairs = 48002**2
    least = _reader("alibi_pair_sums_roofline").least_seconds(calls, pairs, H100)
    assert least == pytest.approx(6 * pairs / 67e12)
    config = spec.cell(CELL).config
    mfu = _reader("mfu_pct.train_alibi")
    plain = spec.load_module(spec.ROOT / "benchmark" / "metrics" / "mfu_pct.train.py")
    t = 1001
    ali_bi = mfu.step_flops(config, t - 1) - 3 * plain.forward_flops(config, t - 1)
    assert ali_bi == pytest.approx(2 * 2 * 2 * t * t * 512)  # 2 layers, D·V forward and its transpose backward

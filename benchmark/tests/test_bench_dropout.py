"""The readers of attention dropout on the flash path: the share of the
training attention calls with dropout that took it, read from the port's
counters in the window, and the two rooflines' counts against a hand
computation, calls without keep bits left out."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import peaks, spec
from benchmark.harness.runner import run_cell
from benchmark.harness.spec import ROOT
from benchmark.harness.trace import OpCall, TraceData
from stamp_tpu_torch.utils import profiling
from stamp_tpu_torch.utils.profiling import Count

from conftest import tiny_cell

H100 = peaks.card_peaks("NVIDIA H100 80GB HBM3")
W0, W1 = 1_000_000_000, 2_000_000_000  # the window, ns
FP32_DOT = 495e12 / 3  # three TF32 products per f32-accurate one


def _metric(name: str):
    return spec.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def _trace(ops: dict | None = None) -> TraceData:
    return TraceData(window_s=1.0, busy_s=0.5, spans=[(W0, W1, "bench/window")], ops=ops or {}, device_ops=[],
                     idle_gaps=[], peaks=H100)  # fmt: skip


def test_the_wholeslide_cell_reads_all_three_and_bag512_the_share():
    for workload, want in (("mil_vit.train.wholeslide", {"flash_dropout_pct.train", "flash_mha_dropout_roofline",
                                                         "flash_mha_dropout_bwd_roofline"}),
                           ("mil_vit.train.bag512", {"flash_dropout_pct.train"})):  # fmt: skip
        cell = spec.cell(workload)
        names = {m["name"] for m in cell.per_layer}
        assert want <= names and not ({"flash_mha_dropout_roofline", "flash_mha_dropout_bwd_roofline"} - want) & names
        for name in want:
            assert callable(spec.metric_reader(cell, name).read)


@pytest.mark.parametrize(("counts", "want"), [
    ([Count(W0 + 1, "train/attn_dropout_flash", 1), Count(W0 + 2, "train/attn_dropout_flash", 1)], 100.0),
    ([Count(W0 + 1, "train/attn_dropout_einsum", 1)], 0.0),
    ([Count(W0 + 1, "train/attn_dropout_flash", 1), Count(W0 + 2, "train/attn_dropout_einsum", 1),
      Count(W0 + 3, "train/attn_dropout_einsum", 1), Count(W0 + 4, "train/attn_dropout_einsum", 1)], 25.0),
    ([Count(W0 - 1, "train/attn_dropout_flash", 1), Count(W1 + 1, "train/attn_dropout_einsum", 1)], None),
    ([], None),
])  # fmt: skip
def test_flash_dropout_share_counts_the_window(monkeypatch, counts, want):
    monkeypatch.setattr(profiling, "records", lambda: list(counts))
    got = _metric("flash_dropout_pct.train").read(_trace())
    assert got == (None if want is None else pytest.approx(want))


def test_flash_dropout_rooflines_by_hand():
    """[8, 16385, 64], 60% of the keys valid (9,831 a sequence), a dense dO:
    the forward needs 4·Q·V·d f32-accurate operations, 1.999 ms at a third
    of the TF32 rate (its bytes, the draws' 4 B a valid pair first, take
    1.659 ms); the backward 10·Q·V·d, 4.998 ms."""
    bh, t, d, valid = 8, 16385, 64, 9831
    pairs = t * bh * valid
    fwd = _metric("flash_mha_dropout_roofline").least_seconds(
        {"bh": bh, "tq": t, "tk": t, "d": d, "valid_keys": torch.tensor(bh * valid)}, H100)
    bwd = _metric("flash_mha_dropout_bwd_roofline").least_seconds(
        {"bh": bh, "tq": t, "tk": t, "d": d, "pairs": torch.tensor(pairs)}, H100)
    assert fwd == pytest.approx(4 * pairs * d / FP32_DOT) == pytest.approx(1.999e-3, rel=1e-3)
    assert bwd == pytest.approx(10 * pairs * d / FP32_DOT) == pytest.approx(4.998e-3, rel=1e-3)
    fwd_bytes = 4 * pairs + 4 * bh * t * d * 3 + bh * t + 4 * bh * t * 513 + 4 * bh * t * d + 4 * bh * t
    assert fwd_bytes / 3.35e12 == pytest.approx(1.659e-3, rel=1e-3)


def test_flash_dropout_rooflines_by_bytes():
    """One valid key a sequence at [8, 4097, 64]: the operations are few and
    the bytes bound both calls: forward 4·8·4097 draws, q k v, the mask
    (1 B a key), the bits (129 words a row), O and lse; backward q k v, O,
    dO, lse, the mask and the bits read, dq dk dv written."""
    bh, t, d = 8, 4097, 64
    fwd = _metric("flash_mha_dropout_roofline").least_seconds(
        {"bh": bh, "tq": t, "tk": t, "d": d, "valid_keys": torch.tensor(bh)}, H100)
    bwd = _metric("flash_mha_dropout_bwd_roofline").least_seconds(
        {"bh": bh, "tq": t, "tk": t, "d": d, "pairs": torch.tensor(bh * t)}, H100)
    fwd_bytes = 4 * t * bh + bh * (4 * 3 * t * d + t + 4 * t * 129 + 4 * t * d + 4 * t)
    bwd_bytes = bh * (4 * 5 * t * d + 4 * t + t + 4 * t * 129 + 4 * 3 * t * d)
    assert fwd == pytest.approx(fwd_bytes / 3.35e12)
    assert bwd == pytest.approx(bwd_bytes / 3.35e12)


def test_calls_without_keep_are_left_out():
    """Calls without keep (all of them in a program that has none) describe themselves as such, and
    a window of them alone reads nothing; a call with keep reads."""
    q = k = v = torch.zeros(2, 40, 32)
    key_mask = torch.ones(2, 40, dtype=torch.bool)
    fwd, bwd = _metric("flash_mha_dropout_roofline"), _metric("flash_mha_dropout_bwd_roofline")
    assert fwd.describe((q, k, v, key_mask, None), {}) == {"keep": False}
    assert bwd.describe((q, k, v, key_mask, q, q[..., 0], q, None), {}) == {"keep": False}
    on = fwd.describe((q, k, v, key_mask, None), {"keep": object()})
    assert on["keep"] and int(on["valid_keys"]) == 80
    on_bwd = bwd.describe((q, k, v, key_mask, q, q[..., 0], q + 1.0, None), {"keep": object()})
    assert on_bwd["keep"] and int(on_bwd["pairs"]) == 2 * 40 * 40
    off = [OpCall(info={"keep": False}, device_s=1e-3)]
    assert fwd.read(_trace({"flash_forward": off})) is None
    assert bwd.read(_trace({"flash_backward": off})) is None
    got = fwd.read(_trace({"flash_forward": off + [OpCall(info=on, device_s=1e-3)]}))
    assert got == pytest.approx(100.0 * fwd.least_seconds(on, H100) / 1e-3)


@pytest.mark.parametrize(("workload", "min_seq", "want"), [
    ("mil_vit.train.wholeslide", 16, 100.0),
    ("mil_vit.train.wholeslide", 4096, 0.0),
    ("mil_vit.train.bag512", 4096, 0.0),
])  # fmt: skip
def test_a_traced_tiny_cell_reads_the_share(monkeypatch, workload, min_seq, want):
    """A tiny cell traced on the CPU: with the flash threshold below its bags
    every training attention call with dropout takes the flash path, at the
    real threshold none (the card's peaks, and so the rooflines, are unknown
    on the CPU)."""
    from stamp_tpu_torch.models import vision_transformer

    monkeypatch.setattr(vision_transformer, "FLASH_ATTENTION_MIN_SEQ", min_seq)
    result = run_cell(tiny_cell(workload), 2**31 + 37, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["flash_dropout_pct.train"]["value"] == want

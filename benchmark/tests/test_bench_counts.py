"""The benchmark's arithmetic against counts made by hand."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import peaks, spec
from benchmark.harness.spec import ROOT

H100 = peaks.card_peaks("NVIDIA H100 80GB HBM3")


def _metric(name: str):
    return spec.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def _config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_peaks_are_the_h100_sxm_data_sheet():
    assert H100["bytes_per_s"] == 3.35e12
    assert H100["flops"] == {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12,
                             "fp8": 1979e12}  # fmt: skip
    assert peaks.card_peaks("NVIDIA A100-SXM4-80GB") is None


@pytest.mark.parametrize(("nbytes", "ops", "seconds", "by"), [
    (3.35e12, {"bf16": 989e12 / 2}, 1.0, "bytes"),
    (3.35e12 / 4, {"bf16": 989e12, "int8": 1979e12}, 2.0, "operations"),
    (0.0, {"fp32_dot": 67e12}, 3 * 67e12 / 495e12, "operations"),  # three TF32 products beat the f32 rate
])  # fmt: skip
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, ops, seconds, by):
    got, got_by = peaks.bound_seconds(nbytes, ops, H100)
    assert got == pytest.approx(seconds) and got_by == by


@pytest.mark.parametrize(("config", "flops"), [
    # UNI2-h: 256 patches + class + 8 registers = 265 tokens, 24 blocks of
    # 2·(1536·4608 + 1536² + 1536·8192 + 4096·1536) a token and 4·265²·1536
    # for attention, and 2·256·588·1536 for the patch embedding
    (_config("uni2_h"), 265 * 24 * 56_623_104 + 24 * 4 * 265**2 * 1536 + 2 * 256 * 588 * 1536),
    # ViT-L/16 with a GELU MLP, no registers: 197 tokens
    (dict(_config("uni2_h"), patch_size=16, embed_dim=1024, mlp_hidden=4096, ffn="mlp", num_reg_tokens=0),
     24 * (197 * 25_165_824 + 4 * 197**2 * 1024) + 2 * 196 * 768 * 1024),
])  # fmt: skip
def test_extractor_model_flops(config, flops):
    assert _metric("mfu_pct.extract").flops_per_tile(config) == flops


def test_uni2_flops_per_tile_is_about_371_gflop():
    assert _metric("mfu_pct.extract").flops_per_tile(_config("uni2_h")) == 370_940_461_056


@pytest.mark.parametrize("tiles", [512, 4095])
def test_mil_training_flops(tiles):
    c = _config("mil_vit")
    t = tiles + 1
    per_layer = 2 * t * 512 * 1536 + 4 * t * t * 512 + 2 * t * 512 * 512 + 2 * 2 * t * 512 * 512
    assert _metric("mfu_pct.train").forward_flops(c, tiles) == 2 * tiles * 1536 * 512 + 2 * per_layer + 2 * 512 * 2


def test_ln_dense_bound_matches_the_kernel_table():
    """PERF.md's row 2: 0.890 ms for qkv + fc1 + fc2 of a UNI2 batch (M = 16,960), operations-bound."""
    m = _metric("ln_dense_roofline")
    sites = [(1536, 4608), (1536, 8192), (4096, 1536)]
    x = {k: torch.empty((16960, k), dtype=torch.bfloat16, device="meta") for k, _ in sites}
    total = sum(m.least_seconds(m.describe((x[k], None, None, torch.empty((n, k), dtype=torch.bfloat16, device="meta")),
                                           {}), H100) for k, n in sites)  # fmt: skip
    assert total * 1e3 == pytest.approx(2 * 16960 * (1536 * 4608 + 1536 * 8192 + 4096 * 1536) / 989e12 * 1e3)
    assert total * 1e3 == pytest.approx(0.890, abs=5e-4)


def test_ln_dense_bytes_bound_at_a_thin_product():
    m = _metric("ln_dense_roofline")
    info = m.describe((torch.empty((4096, 64), dtype=torch.bfloat16, device="meta"), None, None,
                       torch.empty((64, 64), dtype=torch.bfloat16, device="meta")), {})  # fmt: skip
    nbytes = 4096 * 64 * 2 + 64 * 64 * 2 + 4096 * 64 * 2 + (2 * 64 + 64) * 2
    assert m.least_seconds(info, H100) == pytest.approx(nbytes / 3.35e12)


def test_ln_quant_dense_bound_matches_the_kernel_table():
    """PERF.md's row 3: 0.445 ms for the three sites in int8."""
    m = _metric("ln_quant_dense_roofline")
    total = 0.0
    for k, n in [(1536, 4608), (1536, 8192), (4096, 1536)]:
        x = torch.empty((16960, k), dtype=torch.bfloat16, device="meta")
        w = torch.empty((n, k), dtype=torch.int8, device="meta")
        total += m.least_seconds(m.describe((x, None, None, None, w), {}), H100)
    assert total * 1e3 == pytest.approx(0.445, abs=5e-4)


@pytest.mark.parametrize(("b", "n", "dim", "ms"), [(64, 265, 1536, 0.0622), (8, 4096, 512, None)])
def test_fused_qkv_mha_bound(b, n, dim, ms):
    m = _metric("fused_qkv_mha_roofline")
    info = m.describe((torch.empty((b, n, 3 * dim), dtype=torch.bfloat16, device="meta"), dim // 64), {})
    expected = max(4 * b * n * dim * 2 / 3.35e12, 4 * b * n * n * dim / 989e12)
    assert m.least_seconds(info, H100) == pytest.approx(expected)
    if ms is not None:  # PERF.md's row 1: 0.062 ms, bytes-bound
        assert m.least_seconds(info, H100) * 1e3 == pytest.approx(ms, abs=5e-4)

"""The spatial-ALiBi MIL model's training FLOPs (``models/vision_transformer.py``,
``modeling/tasks.py``) over the traced window, as a share of the peak the
configuration names (``peak``: TF32), in %.

``mfu_pct.train``'s count (valid tiles only; three times the forward of the
projection, each layer's linears and attention's two products, and the
head) plus what ALiBi adds in each layer: D·V over every pair of tokens,
2·T²·d in the forward, and its transpose Dᵀ·dO in the backward, 2·T²·d
again (the distances take no gradient).  It reads only the driver's
``row_tiles``."""

from __future__ import annotations

from pathlib import Path

from benchmark.harness.spec import load_module

_PLAIN = load_module(Path(__file__).with_name("mfu_pct.train.py"))


def step_flops(config: dict, tiles: int) -> float:
    t = tiles + 1
    return 3.0 * _PLAIN.forward_flops(config, tiles) + config["n_layers"] * 2 * 2.0 * t * t * config["dim_model"]


def read(trace) -> float | None:
    rows = trace.counts.get("row_tiles")
    if trace.peaks is None or not rows:
        return None
    achieved = sum(step_flops(trace.config, n) for n in rows) / trace.window_s
    return 100.0 * achieved / trace.peaks["flops"][trace.config["peak"]]

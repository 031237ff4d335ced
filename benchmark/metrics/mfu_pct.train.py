"""The MIL model's training FLOPs (``models/vision_transformer.py``,
``modeling/tasks.py``) over the traced window, as a share of the peak the
configuration names (``peak``: TF32, the fastest arithmetic the model runs),
in %.

Model FLOPs count valid tiles only (not the rows that pad a bag to its
bucket): for a bag of n tiles, T = n + 1 tokens with the class token, the
projection of the tiles, each layer's linears over every token and
attention's two products over every pair of tokens, and the head; a
training step is three times its forward."""

from __future__ import annotations


def forward_flops(config: dict, tiles: int) -> float:
    d, f = config["dim_model"], config["dim_feedforward"]
    t = tiles + 1
    project = 2.0 * tiles * config["dim_input"] * d
    layer = 2.0 * t * d * 3 * d + 4.0 * t * t * d + 2.0 * t * d * d + 2.0 * t * d * f * 2
    return project + config["n_layers"] * layer + 2.0 * d * config["n_classes"]


def read(trace) -> float | None:
    rows = trace.counts.get("row_tiles")
    if trace.peaks is None or not rows:
        return None
    achieved = 3.0 * sum(forward_flops(trace.config, n) for n in rows) / trace.window_s
    return 100.0 * achieved / trace.peaks["flops"][trace.config["peak"]]

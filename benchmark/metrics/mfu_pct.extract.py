"""The extractor tower's model FLOPs (``models/vit_image.py``) over the
traced window, as a share of the peak the configuration names (``peak``:
bf16, or int8 for W8A8), in %.

Model FLOPs count the published widths' work for every valid tile whose
forward completed in the window (not the rows that pad a slide's last
batch): the patch embedding, each block's four linears over every token and
attention's two products over every pair of tokens."""

from __future__ import annotations


def flops_per_tile(config: dict) -> float:
    patches = (config["img_size"] // config["patch_size"]) ** 2
    tokens = patches + int(config["class_token"]) + config["num_reg_tokens"]
    dim, hidden = config["embed_dim"], config["mlp_hidden"]
    inner = hidden // 2 if config["ffn"] == "swiglu" else hidden
    patch_embed = 2.0 * patches * 3 * config["patch_size"] ** 2 * dim
    linears = 2.0 * tokens * (dim * 3 * dim + dim * dim + dim * hidden + inner * dim)
    attention = 4.0 * tokens**2 * dim
    return patch_embed + config["depth"] * (linears + attention)


def read(trace) -> float | None:
    if trace.peaks is None or not trace.counts.get("tiles"):
        return None
    achieved = trace.counts["tiles"] * flops_per_tile(trace.config) / trace.window_s
    return 100.0 * achieved / trace.peaks["flops"][trace.config["peak"]]

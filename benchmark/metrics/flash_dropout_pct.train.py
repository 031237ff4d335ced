"""The share of the training attention calls with dropout that took the
flash path (``ops/flash_attention.py``'s rows 4–5 with keep bits), in %:
100 × the port's ``train/attn_dropout_flash`` counts over those and its
``train/attn_dropout_einsum`` counts in the window (one count per call,
made in ``MultiHeadSelfAttention.forward`` by the path it takes).  Whole
slides (every bucket at or above the flash threshold) read 100, bags of 512
tiles 0; a port that counts neither gives nothing."""

from __future__ import annotations

from benchmark.harness.program import count_total


def read(trace) -> float | None:
    flash, einsum = count_total(trace, "train/attn_dropout_flash"), count_total(trace, "train/attn_dropout_einsum")
    if flash is None and einsum is None:
        return None
    return 100.0 * (flash or 0) / ((flash or 0) + (einsum or 0))

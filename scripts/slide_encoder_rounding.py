#!/usr/bin/env python3
"""The rounding error of the port's slide encoders in f32, and what TF32
would add, measured on the CPU.

Each encoder of ``stamp_tpu_torch`` without a kernel (GigaPath, PRISM,
COBRA, MADELEINE, CHIEF) is built at its published width with the port's
seeded random weights and run on 1,500 random tiles three ways: in f32, in
f64 (the reference), and in f32 with the operands of every ``F.linear`` and
``torch.matmul`` rounded to TF32 (10-bit mantissa, round to nearest), which
is what a card's TF32 tensor cores multiply.  It prints, for each, max |Δ| /
max |f64| and 1 − cosine of the f32 and the TF32 forward against f64.

``chip_smoke.py`` sets ``ENCODER_TOL`` (phase 14: the card against the
CPU) between the two: well above the first, well below the second.

    python3 scripts/slide_encoder_rounding.py
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TILES = 1500


def tf32(x):
    """``x`` rounded to TF32's 10 mantissa bits (f32 storage)."""
    import torch

    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def main() -> None:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from stamp_tpu_torch.encoding.encoder.chief import ChiefAttentionNet
    from stamp_tpu_torch.models.slide_encoders import MadeleineNet, PrismPerceiver, init_random_weights_
    from stamp_tpu_torch.models.slide_encoders_cobra import CobraNet
    from stamp_tpu_torch.models.slide_encoders_longnet import LongNetViT

    rng = np.random.default_rng(0)
    idx = np.arange(TILES)
    grid = np.stack([idx % 40, idx // 40], axis=1).astype(np.float32) * 1.07  # float grid units
    models = {
        "gigapath": (LongNetViT(), [rng.standard_normal((TILES, 1536), dtype=np.float32), grid]),
        "prism": (PrismPerceiver(), [rng.standard_normal((TILES, 2560), dtype=np.float32)]),
        "cobra": (CobraNet(), [rng.standard_normal((TILES, 2560), dtype=np.float32)]),
        "madeleine": (MadeleineNet(), [rng.standard_normal((TILES, 512), dtype=np.float32)]),
        "chief": (ChiefAttentionNet(), [rng.standard_normal((TILES, 768), dtype=np.float32)]),
    }
    linear, matmul = F.linear, torch.matmul

    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max()).item()

    def one_minus_cos(a, b) -> float:
        return 1.0 - (torch.dot(a.double(), b.double()) / (a.double().norm() * b.double().norm())).item()

    for name, (model, inputs) in models.items():
        init_random_weights_(model, torch.Generator().manual_seed(0)).eval()
        inputs = [torch.from_numpy(a) for a in inputs]
        last = (lambda out: out[1]) if name == "chief" else (lambda out: out)  # CHIEF: (scores, feature)
        with torch.inference_mode():
            f32 = last(model(*inputs))
            f64 = last(copy.deepcopy(model).double()(*(a.double() for a in inputs))).float()
            F.linear = lambda x, w, b=None: linear(tf32(x), tf32(w), b)
            torch.matmul = lambda a, b: matmul(tf32(a), tf32(b))
            try:
                rounded = last(model(*inputs))
            finally:
                F.linear, torch.matmul = linear, matmul
        row = dict(encoder=name, tiles=TILES, f32_rel_err=rel(f32, f64), f32_one_minus_cos=one_minus_cos(f32, f64),
                   tf32_rel_err=rel(rounded, f64), tf32_one_minus_cos=one_minus_cos(rounded, f64))  # fmt: skip
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

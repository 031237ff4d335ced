"""Driver of extraction cells: ``Extractor.forward`` over a stream of slides.

Set-up makes the tower's weights on the card from the seed (a few large
draws, in bfloat16, by timm's names), hands them to the port through its own
loading path (``resolve_extractor``, whose checkpoint lookup returns them),
draws a pool of uint8 tile batches on the card and keeps them in pinned host
memory, and warms up: the first, full batch (which calibrates a W8A8 tower)
and a ragged one.

The window is a closed loop, as ``stamp preprocess``'s consumer runs: slides
of the traffic's tile counts, in its order, each cut into batches of
``batch`` tiles with a ragged last one; every batch is a pinned host batch
of the pool, handed to ``Extractor.forward`` as soon as the previous call
returned; at a slide's end its features come to the host and to float16
batch by batch, as ``_extract_slide`` does.  The window closes at the first
batch boundary past ``seconds``, after a sync; the rate counts every tile
whose forward completed.

``correct``: every tile of the window is one of the pool's, so every answer
is compared, after the window, with the plain float32 reference's features
of its tile: the worst relative distance ‖f − f_ref‖ / ‖f_ref‖ over all
answers and its median, the answers missing and those not finite, each
against its limit.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from collections.abc import Iterator

import numpy as np
import torch

from benchmark.harness.phases import Phases
from benchmark.harness.roles import param_roles, scale_draw
from benchmark.reference import vit_image as reference

#: ViTConfig fields of the port that must equal the configuration file's
_ARCH_FIELDS = ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "ffn", "num_reg_tokens",
                "class_token", "norm_eps", "pool", "act")  # fmt: skip
SEEDED_CHECKPOINT = "seeded-weights.safetensors"


def _port_arch(config: dict):
    from stamp_tpu_torch.models.vit_image import VIT_CONFIGS

    arch = VIT_CONFIGS[config["arch"]]
    found = {f: getattr(arch, f) for f in _ARCH_FIELDS}
    found["mlp_hidden"] = int(arch.embed_dim * arch.mlp_ratio)
    found["mean"], found["std"] = list(arch.mean), list(arch.std)
    found["no_embed_class"] = not (arch.class_token and arch.pos_embed_cls)
    found["mlp_norm"] = arch.ffn == "swiglu"  # the port's SwiGLU always normalises its gated hidden state
    wanted = {f: config[f] for f in found}
    if found != wanted:
        raise ValueError(f"the port's {config['arch']!r} tower is {found}, the configuration file says {wanted}")
    return arch


def seeded_weights(config: dict, seed: int, device: torch.device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The tower's weights by timm's names, drawn on ``device`` from ``seed``:
    one draw per group of leaves of one role and shape, in state-dict order."""
    from stamp_tpu_torch.models.vit_image import ImageViT

    with torch.device("meta"):
        model = ImageViT(_port_arch(config))
    roles = param_roles(model)
    groups: dict[tuple, list[str]] = {}
    for key, t in model.state_dict().items():
        groups.setdefault((roles[key], tuple(t.shape)), []).append(key)
    g = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for (role, shape), keys in groups.items():
        z = torch.randn((len(keys), *shape), generator=g, device=device, dtype=torch.float32)
        z = scale_draw(z, role, shape, config["assumed"])
        state.update(zip(keys, z.to(dtype).unbind(0)))
    return state


@contextlib.contextmanager
def _port_loads(state: dict[str, torch.Tensor]) -> Iterator[None]:
    """Within the block the port's checkpoint lookup finds ``state`` (its
    loader maps it onto the tower by timm's names, strictly)."""
    from stamp_tpu_torch.preprocessing import extractor as ext

    saved = ext._find_torch_weights, ext._load_torch_state_dict
    ext._find_torch_weights = lambda candidates: SEEDED_CHECKPOINT
    ext._load_torch_state_dict = lambda path: state if path == SEEDED_CHECKPOINT else saved[1](path)
    try:
        yield
    finally:
        ext._find_torch_weights, ext._load_torch_state_dict = saved


def build_extractor(config: dict, state: dict[str, torch.Tensor], device: torch.device, int8: bool):
    """``resolve_extractor`` of the configuration's extractor on ``device``,
    with ``state`` as its weights and int8 extraction as asked."""
    import os

    from stamp_tpu_torch.preprocessing.extractor import set_int8_extraction
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    os.environ.pop("STAMP_RANDOM_WEIGHTS", None)
    os.environ["STAMP_EXTRACT_BATCH"] = str(config["batch"])
    set_int8_extraction(int8)
    try:
        with _port_loads(state):
            return resolve_extractor(config["extractor"], device)
    finally:
        set_int8_extraction(None)


class Session:
    """One extraction cell's run: set-up in the constructor, then
    ``run_window`` and ``check``.

    ``control`` puts the configuration's control in the program's place
    (bf16: the port's own W8A8 path; int8: the reference with int4 weights
    and activations); ``fault`` plants one ("answer_altered": one tile's
    features altered where they are produced)."""

    def __init__(self, cell, seed: int, device: torch.device, *, control: bool = False, fault: str | None = None):
        self.config, self.traffic, self.limits = dict(cell.config, batch=cell.traffic["batch"]), cell.traffic, cell.limits
        self.seed, self.device = seed, device
        self.int8 = self.config["precision"] == "int8"
        phases = Phases()
        batch, px = self.traffic["batch"], self.config["img_size"]
        g = torch.Generator(device=device).manual_seed(seed + 1)
        pool = torch.randint(0, 256, (self.traffic["pool_batches"], batch, px, px, 3), generator=g,
                             device=device, dtype=torch.uint8)  # fmt: skip
        self.pool_host = [b.cpu().pin_memory() if device.type == "cuda" else b for b in pool]
        del pool
        phases.mark("tile pool")
        self.answers: list[np.ndarray] = []  # float16 features, slide by slide
        self.answer_rows: list[tuple[int, int]] = []  # (pool batch, rows) of each forward, in order
        self.extractor_is_reference = control and self.int8  # the int4 reference in the program's place
        self.extractor = self.forward = None
        if not self.extractor_is_reference:
            state = seeded_weights(self.config, seed, device)
            phases.mark("the port's imports, weights")
            self.extractor = build_extractor(self.config, state, device, int8=self.int8 or control)
            del state
            phases.mark("resolve_extractor")
            self.forward = self.extractor.forward
            if fault == "answer_altered":
                self.forward = _altered(self.forward, call=1)
            # the shapes of the window: a full batch (W8A8 calibrates on it) and a ragged one
            self.extractor.forward(self.pool_host[0])
            self.extractor.forward(self.pool_host[1][: batch // 3])
            _sync(device)
            phases.mark("warm-up (W8A8: calibration)")
        phases.report()

    def run_window(self, seconds: float, tracer) -> dict:
        if self.extractor_is_reference:  # the control's readings need no window
            return {"tiles": 0, "batches": 0, "slides_completed": 0, "window_s": 0.0, "extract_tiles_per_s": 0.0}
        batch, pool = self.traffic["batch"], len(self.pool_host)
        self.answers, self.answer_rows = [], []
        tiles = batches = slides = 0
        t0 = time.perf_counter()
        with tracer.span("bench/window"):
            for slide, n_tiles in enumerate(_cycle(self.traffic["slide_tiles"])):
                feats = []
                for j in range(math.ceil(n_tiles / batch)):
                    n, p = min(batch, n_tiles - j * batch), (slide + j) % pool
                    with tracer.span("bench/Extractor.forward"):
                        feats.append(self.forward(self.pool_host[p] if n == batch else self.pool_host[p][:n]))
                    self.answer_rows.append((p, n))
                    tiles, batches = tiles + n, batches + 1
                    if time.perf_counter() - t0 >= seconds:
                        break
                else:
                    with tracer.span("bench/slide_end"):  # _extract_slide's features to the host
                        self.answers.append(_host_fp16(feats))
                    slides += 1
                    continue
                break  # the window is over, in the middle of this slide
            with tracer.span("bench/sync"):
                _sync(self.device)
        window_s = time.perf_counter() - t0
        self.answers.append(_host_fp16(feats))  # the open slide's, after the window
        return {"tiles": tiles, "batches": batches, "slides_completed": slides, "window_s": window_s,
                "extract_tiles_per_s": tiles / window_s}  # fmt: skip

    def free_program(self) -> None:
        self.extractor = self.forward = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference_features(self, quant: str | None = None) -> torch.Tensor:
        """The reference's float32 features of every pool tile, [pool·batch, D]."""
        state = {k: t.float() for k, t in seeded_weights(self.config, self.seed, self.device).items()}
        block = self.traffic["reference_block"]
        out = []
        for host in self.pool_host:
            images = host.to(self.device)
            out += [reference.features(state, self.config, images[i : i + block], quant) for i in range(0, len(images), block)]
        return torch.cat(out)

    def check(self) -> dict:
        """{name: (value, limit)}: the numbers ``correct`` compares."""
        self.free_program()
        ref = self._reference_features()
        batch = self.traffic["batch"]
        if self.extractor_is_reference:  # the control's answers: the int4 reference's, every pool tile
            got = self._reference_features("int4")
            rows = torch.arange(len(got), device=self.device)
        else:
            got = torch.from_numpy(np.concatenate(self.answers)).to(self.device).float()
            rows = torch.cat([torch.arange(p * batch, p * batch + n, device=self.device) for p, n in self.answer_rows])
        self.attempted = len(rows)
        n = min(len(got), len(rows))
        want = ref[rows[:n]]
        dist = (got[:n] - want).norm(dim=1) / want.norm(dim=1)
        finite = torch.isfinite(got[:n]).all(dim=1)
        limit = self.limits["feat_rel_err_max"]
        worst, median = (float(dist[finite].max()), float(dist[finite].median())) if bool(finite.any()) else (math.inf,) * 2
        missing, not_finite = abs(len(rows) - len(got)), int((~finite).sum())
        self.failed = missing + not_finite + int((dist[finite] > limit).sum())
        return {"feat_rel_err_max": (worst, limit), "feat_rel_err_median": (median, self.limits["feat_rel_err_median"]),
                "answers_missing": (missing, 0), "answers_not_finite": (not_finite, 0)}  # fmt: skip


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_fp16(feats: list[torch.Tensor]) -> np.ndarray:
    return np.concatenate([f.cpu().numpy().astype(np.float16) for f in feats])


def _cycle(counts: list[int]) -> Iterator[int]:
    while True:
        yield from counts


def _altered(forward, call: int):
    """``forward`` whose ``call``-th call in the window alters its first tile's features (negates them)."""
    seen = [0]

    def altered(batch):
        feats = forward(batch)
        seen[0] += 1
        if seen[0] == call:
            feats = feats.clone()
            feats[0] = -feats[0]
        return feats

    return altered

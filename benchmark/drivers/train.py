"""Driver of training cells: the port's training step over a cohort on the card.

Set-up draws the cohort on the card from the seed (every patient's tile
features, float32, and their labels; the tile counts and the patients'
order are fixed by the traffic, never by the seed, so every seed does the
same work), builds the task model as ``_train_model_impl`` does
(``LitTileClassifier`` around the MIL ``VisionTransformer``,
``make_optimizer``, ``lr_schedule`` and ``make_dp_train_step`` with
``forward_batch``), gives it initial weights drawn on the card from the seed
in one draw, and drives it through its first ``compared_steps`` steps
through the window's own call and feed.  Whole-slide traffic puts one
patient of each bucket first, so those steps also warm up every shape the
window runs.  Dropout draws its masks from a generator the driver seeds.

The feed hands each step's batch over as the prefetching feed hands it: on
the card.  Whole slides (``bag_size`` null, batch 1): the patient's bag
padded with zeros to its bucket (the next power of two of at least 512
tiles, ``_pad_tile_batch``'s rule) with its key mask; bags of ``bag_size``:
``bag_size`` tiles of each of ``batch_size`` patients, drawn without
replacement on the card.  The window is a closed loop of steps; it closes at
the first step boundary past ``seconds``, after a sync; the rate counts the
valid tiles of every step in it.

``correct``: the plain float32 reference (``reference/mil_vit.py``) follows
the first steps from the same initial weights on the same bags, unpadded,
with the same dropout masks.  Once the window has closed the program takes
``late_steps`` more steps through the same call, the dropout generator
seeded anew; the reference follows them from the program's weights and
AdamW moments at that point.  Compared: each step's loss; each compared
step's gradient as AdamW takes it in (after the first step its first moment
over 1 − β1; after a late step the moment's change over 1 − β1); each
parameter's change after the first steps.  Gradients and changes are taken
by the worst leaf: the gap between the program's norm and the reference's,
over the larger of the reference's norm of that leaf and of the median
leaf; the change leaves out the elements whose reference gradient is under
a thousandth of the median leaf's root mean square (they move under Adam by
round-off alone, as a key's bias does under softmax).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from benchmark.harness.phases import Phases
from benchmark.harness.roles import param_roles, scale_draw
from benchmark.reference import mil_vit as reference

BETA1 = 0.9  # AdamW's, as the task model makes it
GRAD_FLOOR = 1e-3  # an element whose reference gradient is under this share of the median leaf's RMS is left out of the change
CHUNK = 1 << 28  # elements a draw of the cohort makes at once


def tile_counts(traffic: dict) -> list[int]:
    """The patients' tile counts: fixed quantiles of the log-uniform range."""
    lo, hi, n = math.log(traffic["tiles_min"]), math.log(traffic["tiles_max"]), traffic["patients"]
    return [int(round(math.exp(lo + (i + 0.5) / n * (hi - lo)))) for i in range(n)]


def bucket_size(n: int, minimum: int = 512) -> int:
    """The whole-slide bucket: the next power of two ≥ n, at least ``minimum``."""
    return minimum if n <= minimum else 1 << math.ceil(math.log2(n))


def total_steps(config: dict, traffic: dict) -> int:
    """The schedule's length as ``stamp train`` sets it: steps an epoch over
    the training share of the cohort, times ``max_epochs``."""
    per_epoch = math.ceil(round(traffic["patients"] * traffic["train_share"]) / traffic["batch_size"])
    return per_epoch * config["max_epochs"]


def seeded_init(module: torch.nn.Module, config: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Initial float32 weights by the module's names, from one draw on ``device``."""
    roles = param_roles(module)
    shapes = {name: tuple(p.shape) for name, p in module.named_parameters()}
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=g, device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = scale_draw(z[offset : offset + n].view(shape), roles[name], shape, config["assumed"]).clone()
        offset += n
    return out


class Session:
    """One training cell's run: set-up in the constructor, then
    ``run_window`` and ``check``.

    ``control`` puts the reference computed in bfloat16 in the program's
    place (no window runs); ``fault`` plants one in the program:
    "state_unchanged" (the optimizer updates nothing), "half_batch" (the
    loss over the first half of the batch's rows), "answer_altered" (the
    first row's first logit altered where the model produces it)."""

    def __init__(self, cell, seed: int, device: torch.device, *, control: bool = False, fault: str | None = None):
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.seed, self.device, self.control = seed, device, control
        c, t = self.config, self.traffic
        phases = Phases()
        self.counts = tile_counts(t)
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)[:-1]])
        self.offsets_dev = torch.tensor(self.offsets, device=device)
        self.counts_dev = torch.tensor(self.counts, device=device)
        g = torch.Generator(device=device).manual_seed(seed)
        total = sum(self.counts)
        self.features = torch.empty((total, c["dim_input"]), device=device)
        flat = self.features.view(-1)
        for start in range(0, flat.numel(), CHUNK):
            flat[start : start + CHUNK].normal_(generator=g)
        self.labels = torch.randint(0, c["n_classes"], (t["patients"],), generator=g, device=device)
        self.targets = torch.nn.functional.one_hot(self.labels, c["n_classes"]).float()
        order = np.random.default_rng(0).permutation(t["patients"]).tolist()  # the same sizes in the same order for every seed
        if t["bag_size"] is None:  # one patient of each bucket first: the first steps warm every shape up
            first = {}
            for p in order:
                first.setdefault(bucket_size(self.counts[p]), p)
            lead = [first[b] for b in sorted(first)]
            order = lead + [p for p in order if p not in lead]
        self.order = order
        self.sampler = torch.Generator(device=device).manual_seed(seed + 1)
        self.max_tiles = max(self.counts)
        grid = torch.arange(bucket_size(self.max_tiles), device=device)
        self.grid = torch.stack([grid % 128, grid // 128], dim=-1).float() * 224.0  # µm, a tile every 224
        self.schedule = {"total_steps": total_steps(c, t), "max_lr": c["max_lr"], "div_factor": c["div_factor"]}
        self.init_seed, self.dropout_seeds = seed + 2, (seed + 3, seed + 4)  # the first steps', the late steps'
        phases.mark("cohort")
        self.compared: list[tuple[torch.Tensor, torch.Tensor, int]] = []  # the reference's inputs of the first steps
        self.count = self.next_feed = 0
        if control:
            for i in range(t["compared_steps"]):
                self.compared.append(self._reference_input(self.feed(i)))
            return
        self._build_program(fault, phases)
        phases.mark("task model")
        self.first_losses = []
        for i in range(t["compared_steps"]):
            batch, key_mask, rows = self.feed(i)
            loss, _ = self.step(batch, key_mask, self.count)
            self.count += 1
            self.first_losses.append(loss)
            self.compared.append(self._reference_input((batch, key_mask, rows)))
            if i == 0:
                self.grad1 = {name: self._moment(p).norm() / (1 - BETA1) for name, p in self.params.items()}
        self.change = {name: p.detach() - self.init[name] for name, p in self.params.items()}
        self.next_feed = t["compared_steps"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        phases.mark("first steps")
        phases.report()

    def _build_program(self, fault: str | None, phases: Phases) -> None:
        from stamp_tpu_torch.modeling.tasks import LitTileClassifier
        from stamp_tpu_torch.modeling.train import forward_batch
        from stamp_tpu_torch.models.vision_transformer import VisionTransformer
        from stamp_tpu_torch.parallel.mesh import make_dp_train_step

        phases.mark("the port's imports")

        c, device = self.config, self.device
        labels = np.bincount(self.labels.cpu().numpy(), minlength=c["n_classes"])
        reciprocal = labels.sum() / labels
        task = LitTileClassifier(
            model_class=VisionTransformer, ground_truth_label="label",
            categories=[str(i) for i in range(c["n_classes"])],
            category_weights=(reciprocal / reciprocal.sum()).astype(np.float32),
            dim_input=c["dim_input"], total_steps=self.schedule["total_steps"], max_lr=c["max_lr"],
            div_factor=c["div_factor"], **{k: c[k] for k in ("dim_model", "dim_feedforward", "n_heads", "n_layers",
                                                             "dropout", "use_alibi")},
        )  # fmt: skip
        module = task.module.to(device)
        self.init = seeded_init(module, c, self.init_seed, device)
        module.load_state_dict(self.init)
        self.params = dict(module.named_parameters())
        if fault in ("half_batch", "answer_altered"):
            task.loss = _faulty_loss(task.loss, fault)
        optimizer = task.make_optimizer(module.parameters())
        if fault == "state_unchanged":
            optimizer.step = lambda *args, **kwargs: None
        self.optimizer = optimizer
        self.dropout_generator = generator = torch.Generator(device=device).manual_seed(self.dropout_seeds[0])
        self.step = make_dp_train_step(
            task, optimizer, None, schedule=task.lr_schedule(),
            forward=lambda batch, key_mask, group: forward_batch(
                task, batch, key_mask, device, train=True, generator=generator, group=group
            ),
        )  # fmt: skip

    def _moment(self, p: torch.Tensor, key: str = "exp_avg") -> torch.Tensor:
        state = self.optimizer.state.get(p, {})
        return state[key] if key in state else torch.zeros_like(p)

    def feed(self, i: int) -> tuple[tuple, torch.Tensor | None, list[int]]:
        """Step ``i``'s (batch, key mask, valid tiles of each row), on the card."""
        t, dev = self.traffic, self.device
        n_patients = len(self.order)
        if t["bag_size"] is None:
            p = self.order[i % n_patients]
            n, off = self.counts[p], int(self.offsets[p])
            bucket = bucket_size(n)
            bags = torch.zeros((1, bucket, self.features.shape[1]), device=dev)
            bags[0, :n] = self.features[off : off + n]
            coords = torch.zeros((1, bucket, 2), device=dev)
            coords[0, :n] = self.grid[:n]
            key_mask = (torch.arange(bucket, device=dev) < n)[None]
            return (bags, coords, np.array([n]), self.targets[p][None]), key_mask, [n]
        b, size = t["batch_size"], t["bag_size"]
        start = (i * b) % n_patients
        patients = torch.tensor(self.order[start : start + b], device=dev)
        keys = torch.rand((b, self.max_tiles), generator=self.sampler, device=dev)
        keys.masked_fill_(torch.arange(self.max_tiles, device=dev)[None] >= self.counts_dev[patients][:, None], 2.0)
        idx = keys.topk(size, dim=1, largest=False).indices  # bag_size tiles of each, without replacement
        bags = self.features[self.offsets_dev[patients][:, None] + idx]
        batch = (bags, self.grid[idx], np.full(b, size), self.targets[patients])
        return batch, None, [size] * b

    def _reference_input(self, fed) -> tuple[torch.Tensor, torch.Tensor, int]:
        """The reference's (bags, targets, the program's padded tiles) of a
        step: whole-slide bags unpadded."""
        (bags, _coords, _sizes, targets), _key_mask, rows = fed
        padded = bags.shape[1]
        if self.traffic["bag_size"] is None:
            bags = bags[:, : rows[0]]
        return bags.clone(), targets.clone(), padded

    def run_window(self, seconds: float, tracer) -> dict:
        if self.control:  # the control's readings need no window
            self.attempted = 0
            return {"tiles": 0, "steps": 0, "row_tiles": [], "window_s": 0.0, "train_tiles_per_s": 0.0}
        tiles = steps = 0
        row_tiles: list[int] = []
        i = self.next_feed
        t0 = time.perf_counter()
        with tracer.span("bench/window"):
            while True:
                with tracer.span("bench/feed"):
                    batch, key_mask, rows = self.feed(i)
                with tracer.span("bench/step"):
                    self.step(batch, key_mask, self.count)
                self.count, i, steps = self.count + 1, i + 1, steps + 1
                tiles += sum(rows)
                row_tiles += rows
                if time.perf_counter() - t0 >= seconds:
                    break
            with tracer.span("bench/sync"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t0
        self.attempted, self.next_feed = steps, i
        return {"tiles": tiles, "steps": steps, "row_tiles": row_tiles, "window_s": window_s,
                "train_tiles_per_s": tiles / window_s}  # fmt: skip

    def _late_steps(self) -> None:
        """``late_steps`` more steps through the window's call, from the
        state the window left: their inputs, the program's state before them,
        and what the program made of them (losses, gradients from AdamW's
        first moment)."""
        params = self.params.values()
        self.late_start = {name: p.detach().clone() for name, p in self.params.items()}
        self.late_moments = tuple({name: self._moment(p, key).clone() for name, p in self.params.items()}
                                  for key in ("exp_avg", "exp_avg_sq"))  # fmt: skip
        self.late_count = self.count
        self.dropout_generator.manual_seed(self.dropout_seeds[1])
        self.late_inputs, self.late_losses, self.late_grads = [], [], []
        before = [self._moment(p).clone() for p in params]
        for _ in range(self.traffic["late_steps"]):
            fed = self.feed(self.next_feed)
            loss, _ = self.step(fed[0], fed[1], self.count)
            self.count, self.next_feed = self.count + 1, self.next_feed + 1
            self.late_inputs.append(self._reference_input(fed))
            self.late_losses.append(float(loss))
            after = [self._moment(p).clone() for p in params]
            self.late_grads.append({name: ((a - BETA1 * b) / (1 - BETA1)).norm()
                                    for name, a, b in zip(self.params, after, before)})  # fmt: skip
            before = after

    def free_program(self) -> None:
        self.step = self.optimizer = self.params = self.dropout_generator = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _dropout_draws(self, stage: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.dropout_seeds[stage])

    def check(self) -> dict:
        """{name: (value, limit)}: the numbers ``correct`` compares."""
        weights = reference.class_weights(self.labels, self.config["n_classes"])
        late = None
        if self.control:  # the reference in bfloat16 in the program's place, over the first steps
            init = seeded_init(_names_module(self), self.config, self.init_seed, self.device)
            got = reference.train(init, self.compared, weights, self.config, self.schedule, dtype=torch.bfloat16,
                                  generator=self._dropout_draws(0))  # fmt: skip
            losses, grads, change = got["losses"], [{k: v.norm() for k, v in got["grads"][0].items()}], got["change"]
        else:
            self._late_steps()
            init, change = self.init, self.change
            losses, grads = [float(x) for x in self.first_losses] + self.late_losses, [self.grad1] + self.late_grads
            late = (self.late_start, self.late_moments, self.late_count, self.late_inputs)
            self.free_program()
        ref = reference.train(init, self.compared, weights, self.config, self.schedule, generator=self._dropout_draws(0))
        ref_losses, ref_grads = ref["losses"], ref["grads"][:1]
        if late is not None:
            start, moments, count, inputs = late
            ref_late = reference.train(start, inputs, weights, self.config, self.schedule, moments=moments, count=count,
                                       generator=self._dropout_draws(1))  # fmt: skip
            ref_losses, ref_grads = ref_losses + ref_late["losses"], ref_grads + ref_late["grads"]
        # elements whose reference gradient is nought to rounding (a key's bias under softmax) move by round-off alone
        grad1 = ref["grads"][0]
        floor = GRAD_FLOOR * statistics.median(float(v.pow(2).mean().sqrt()) for v in grad1.values())
        kept = {k: v.abs() >= floor for k, v in grad1.items()}
        ref_change = {k: float((ref["change"][k] * kept[k]).norm()) for k in kept if bool(kept[k].any())}
        got_change = {k: float((change[k] * kept[k]).norm()) for k in ref_change}
        numbers = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_gap": max(_worst_leaf({k: float(v) for k, v in got.items()}, {k: float(v.norm()) for k, v in want.items()})
                            for got, want in zip(grads, ref_grads)),  # fmt: skip
            "change_gap": _worst_leaf(got_change, ref_change),
        }
        numbers = {k: (v if math.isfinite(v) else math.inf) for k, v in numbers.items()}
        self.failed = sum(v > self.limits[k] for k, v in numbers.items())
        self.attempted = getattr(self, "attempted", 0)
        return {k: (v, self.limits[k]) for k, v in numbers.items()}


def _worst_leaf(got: dict[str, float], want: dict[str, float]) -> float:
    """max over leaves of |got − want| over the larger of want and the median leaf's want."""
    median = statistics.median(want.values())
    return max(abs(got[k] - v) / max(v, median) for k, v in want.items())


def _names_module(session: Session) -> torch.nn.Module:
    """The MIL model's module, for its parameters' names and shapes only."""
    from stamp_tpu_torch.models.vision_transformer import VisionTransformer

    c = session.config
    with torch.device("meta"):
        return VisionTransformer(
            dim_output=c["n_classes"], dim_input=c["dim_input"],
            **{k: c[k] for k in ("dim_model", "dim_feedforward", "n_heads", "n_layers", "dropout", "use_alibi")},
        )  # fmt: skip


def _faulty_loss(loss, fault: str):
    def faulty(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if fault == "half_batch":
            half = max(len(outputs) // 2, 1)
            return loss(outputs[:half], targets[:half])
        altered = outputs.clone()
        altered[0, 0] = altered[0, 0] + 1.0
        return loss(altered, targets)

    return faulty

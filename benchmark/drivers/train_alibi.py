"""Driver of spatial-ALiBi training cells: ``train.py``'s session with the
ALiBi ``vit``'s state, coordinates and reference.

Everything ``train.py`` says holds, with four differences:

- The initial state: ``train.seeded_init``'s draw for every parameter but
  the per-head ``bias_scale``, which is uniform on [0, 1) (the module's own
  draw), from its own generator seeded from the run's seed; the ALiBi
  buffers ``running_mean`` and ``items_so_far`` start at 1, as the module
  makes them.
- The reference (``reference/mil_vit_alibi.py``) takes each bag with its
  coordinates (unpadded: the feed's 224 µm grid) and follows the ALiBi
  buffers with its own Welford updates; the late steps start it from the
  program's parameters, AdamW moments and buffers.
- The compared numbers are ``train.py``'s (``loss_gap``, ``grad_gap``,
  ``change_gap``), ``bias_scale`` a leaf like any other; ``change_gap``
  also leaves out the elements whose reference gradient is under
  ``EPS_FLOOR`` (100 × AdamW's ε).  Near ε AdamW moves an element in
  proportion to its gradient rather than by the gradient's sign, so its
  change carries the gradient's rounding: the TF32 products of rows 6–8
  round the last block's q and k projections' gradients, which reach them
  through the class token's row alone, by 2–3% of the leaf (the first
  block's by ≤ 2.3e-4), and those leaves' kept elements sit near ε.  At
  100 ε an update is within 1% of its sign's.
- Three planted faults of its own: two in the statistic the model reads
  (``pairwise_distance_sums`` where ``models/vision_transformer.py`` looks it
  up), "welford_skipped" (the statistic reads 1, so the running means stay
  at their initial 1) and "padded_rows" (the bucket padding's rows and keys
  counted in it), and "update_scaled" (every AdamW update 10% too large,
  which at the warm-up's learning rates neither the loss nor the gradients
  see); ``train.py``'s faults hold too.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from benchmark.drivers import train
from benchmark.harness.phases import Phases
from benchmark.reference import mil_vit_alibi as reference

FAULTS = ("welford_skipped", "padded_rows", "update_scaled")
ADAM_EPS = 1e-8  # ``LitTileClassifier.make_optimizer``'s and the reference's
EPS_FLOOR = 100 * ADAM_EPS  # an element whose reference gradient is under this is left out of the change
_STATISTIC = ("stamp_tpu_torch.models.vision_transformer", "pairwise_distance_sums")


def initial_state(module: torch.nn.Module, config: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Initial float32 parameters and ALiBi buffers by the module's names."""
    state = train.seeded_init(module, config, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    for name in sorted(state):
        if name.endswith(".bias_scale"):
            state[name] = torch.rand(state[name].shape, generator=g, device=device)
    for name, buf in module.named_buffers():
        state[name] = torch.ones(buf.shape, device=device)
    return state


def _faulty_statistic(original, fault: str):
    def statistic(coords, *, mask=None, coords_k=None, key_mask=None, **kwargs):
        if fault == "padded_rows":
            return original(coords, coords_k=coords_k, **kwargs)
        _total, n_pairs = original(coords, mask=mask, coords_k=coords_k, key_mask=key_mask, **kwargs)
        return n_pairs, n_pairs  # a mean of 1: the running means stay at their initial 1

    return statistic


class Session(train.Session):
    """``train.Session`` for the ALiBi ``vit``; ``fault`` may also be one of ``FAULTS``."""

    def _build_program(self, fault: str | None, phases: Phases) -> None:
        import importlib

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
        self.module = module = task.module.to(device)
        self.init = initial_state(module, c, self.init_seed, device)
        module.load_state_dict(self.init)
        self.params = dict(module.named_parameters())
        self._restore = None
        if fault in ("welford_skipped", "padded_rows"):
            owner = importlib.import_module(_STATISTIC[0])
            original = getattr(owner, _STATISTIC[1])
            self._restore = (owner, original)
            setattr(owner, _STATISTIC[1], _faulty_statistic(original, fault))
        elif fault in ("half_batch", "answer_altered"):
            task.loss = train._faulty_loss(task.loss, fault)
        optimizer = task.make_optimizer(module.parameters())
        if fault == "state_unchanged":
            optimizer.step = lambda *args, **kwargs: None
        self.optimizer = optimizer
        self.dropout_generator = generator = torch.Generator(device=device).manual_seed(self.dropout_seeds[0])
        schedule = task.lr_schedule()
        if fault == "update_scaled":
            schedule = lambda count, lr=schedule: 1.1 * lr(count)  # noqa: E731
        self.step = make_dp_train_step(
            task, optimizer, None, schedule=schedule,
            forward=lambda batch, key_mask, group: forward_batch(
                task, batch, key_mask, device, train=True, generator=generator, group=group
            ),
        )  # fmt: skip

    def _reference_input(self, fed) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """The reference's (bags, coordinates, targets, the program's padded
        tiles) of a step: whole-slide bags unpadded."""
        (bags, coords, _sizes, targets), _key_mask, rows = fed
        padded = bags.shape[1]
        if self.traffic["bag_size"] is None:
            bags, coords = bags[:, : rows[0]], coords[:, : rows[0]]
        return bags.clone(), coords.clone(), targets.clone(), padded

    def _late_steps(self) -> None:
        self.late_buffers = {name: b.detach().clone() for name, b in self.module.named_buffers()}
        super()._late_steps()

    def free_program(self) -> None:
        if getattr(self, "_restore", None) is not None:
            owner, original = self._restore
            setattr(owner, _STATISTIC[1], original)
            self._restore = None
        self.module = None
        super().free_program()

    def check(self) -> dict:
        """{name: (value, limit)}: the numbers ``correct`` compares, as ``train.Session.check`` forms them."""
        weights = reference.class_weights(self.labels, self.config["n_classes"])
        late = None
        if self.control:  # the reference in bfloat16 in the program's place, over the first steps
            init = initial_state(train._names_module(self), self.config, self.init_seed, self.device)
            got = reference.train(init, self.compared, weights, self.config, self.schedule, dtype=torch.bfloat16,
                                  generator=self._dropout_draws(0))  # fmt: skip
            losses, grads, change = got["losses"], [{k: v.norm() for k, v in got["grads"][0].items()}], got["change"]
        else:
            self._late_steps()
            init, change = self.init, self.change
            losses = [float(x) for x in self.first_losses] + self.late_losses
            grads = [self.grad1] + self.late_grads
            late = (dict(self.late_start, **self.late_buffers), self.late_moments, self.late_count, self.late_inputs)
            self.free_program()
        ref = reference.train(init, self.compared, weights, self.config, self.schedule,
                              generator=self._dropout_draws(0))  # fmt: skip
        ref_losses, ref_grads = ref["losses"], ref["grads"][:1]
        if late is not None:
            start, moments, count, inputs = late
            ref_late = reference.train(start, inputs, weights, self.config, self.schedule, moments=moments, count=count,
                                       generator=self._dropout_draws(1))  # fmt: skip
            ref_losses, ref_grads = ref_losses + ref_late["losses"], ref_grads + ref_late["grads"]
        grad1 = ref["grads"][0]
        floor = max(train.GRAD_FLOOR * statistics.median(float(v.pow(2).mean().sqrt()) for v in grad1.values()),
                    EPS_FLOOR)  # fmt: skip
        kept = {k: v.abs() >= floor for k, v in grad1.items()}
        ref_change = {k: float((ref["change"][k] * kept[k]).norm()) for k in kept if bool(kept[k].any())}
        got_change = {k: float((change[k] * kept[k]).norm()) for k in ref_change}
        numbers = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_gap": max(train._worst_leaf({k: float(v) for k, v in got.items()},
                                              {k: float(v.norm()) for k, v in want.items()})
                            for got, want in zip(grads, ref_grads)),  # fmt: skip
            "change_gap": train._worst_leaf(got_change, ref_change),
        }
        numbers = {k: (v if math.isfinite(v) else math.inf) for k, v in numbers.items()}
        self.failed = sum(v > self.limits[k] for k, v in numbers.items())
        return {k: (v, self.limits[k]) for k, v in numbers.items()}

"""The plain references against ``stamp_tpu_torch`` on the CPU at tiny widths."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.drivers import extract, train
from benchmark.harness.runner import run_cell
from benchmark.reference import mil_vit, vit_image

from conftest import TINY_MIL, tiny_cell


def test_vit_reference_matches_the_port(tiny_uni2):
    from stamp_tpu_torch.models.vit_image import ImageViT

    cell = tiny_cell("uni2.extract.bf16")
    state = extract.seeded_weights(cell.config, 5, torch.device("cpu"), dtype=torch.float32)
    with torch.device("meta"):
        model = ImageViT(tiny_uni2)
    model.load_state_dict(state, assign=True)
    images = torch.randint(0, 256, (3, 224, 224, 3), generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    mean, std = torch.tensor(tiny_uni2.mean) * 255.0, torch.tensor(tiny_uni2.std) * 255.0
    with torch.inference_mode():
        port = model((images.float() - mean) / std)
    ref = vit_image.features(state, cell.config, images)
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-4), (port - ref).abs().max()


def test_int4_control_is_far_from_float32(tiny_uni2):
    cell = tiny_cell("uni2.extract.bf16")
    state = extract.seeded_weights(cell.config, 5, torch.device("cpu"), dtype=torch.float32)
    images = torch.randint(0, 256, (2, 224, 224, 3), generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    ref, control = vit_image.features(state, cell.config, images), vit_image.features(state, cell.config, images, "int4")
    assert float(((control - ref).norm(dim=1) / ref.norm(dim=1)).min()) > 0.05


def _mil(n_classes=2):
    from stamp_tpu_torch.models.vision_transformer import VisionTransformer

    c = dict(tiny_cell("mil_vit.train.wholeslide").config)
    model = VisionTransformer(dim_output=n_classes, dim_input=c["dim_input"],
                              **{k: c[k] for k in ("dim_model", "dim_feedforward", "n_heads", "n_layers", "dropout",
                                                   "use_alibi")})  # fmt: skip
    params = train.seeded_init(model, c, 7, torch.device("cpu"))
    model.load_state_dict(params)
    return c, model, params


@pytest.mark.parametrize(("n", "bucket"), [(300, 512), (3000, 4096)])  # the einsum path, and the flash path's plain version
def test_mil_reference_matches_the_port_on_a_padded_bag(n, bucket):
    c, model, params = _mil()
    bag = torch.randn(1, n, TINY_MIL["dim_input"], generator=torch.Generator().manual_seed(2))
    padded = torch.cat([bag, torch.zeros(1, bucket - n, bag.shape[2])], dim=1)
    mask = torch.arange(bucket)[None] < n
    with torch.no_grad():
        port = model(padded, coords=torch.zeros(1, bucket, 2), key_mask=mask)
        ref = mil_vit.forward(params, bag, c)
    assert torch.allclose(port, ref, rtol=1e-5, atol=1e-5), (port - ref).abs().max()


@pytest.mark.parametrize(("n", "bucket"), [(300, 512), (512, 512)])
def test_mil_reference_replays_the_ports_dropout(n, bucket):
    """In training the port draws dropout's masks from the generator it is
    handed; the reference, given a generator seeded alike and the padded
    length, draws the same masks: the same logits, which differ from the
    forward without dropout."""
    c, model, params = _mil()
    assert c["dropout"] == 0.25
    bag = torch.randn(1, n, TINY_MIL["dim_input"], generator=torch.Generator().manual_seed(3))
    padded = torch.cat([bag, torch.zeros(1, bucket - n, bag.shape[2])], dim=1)
    mask = torch.arange(bucket)[None] < n
    with torch.no_grad():
        port = model(padded, coords=torch.zeros(1, bucket, 2), key_mask=mask, train=True,
                     generator=torch.Generator().manual_seed(4))  # fmt: skip
        ref = mil_vit.forward(params, bag, c, torch.Generator().manual_seed(4), bucket)
        plain = mil_vit.forward(params, bag, c)
    assert torch.allclose(port, ref, rtol=1e-5, atol=1e-5), (port - ref).abs().max()
    assert not torch.allclose(ref, plain, rtol=1e-3, atol=1e-3)


def test_schedule_and_class_weights_match_the_port():
    from stamp_tpu_torch.modeling.tasks import cosine_onecycle_schedule

    schedule = cosine_onecycle_schedule(transition_steps=192, peak_value=1e-4, pct_start=0.3, div_factor=25.0,
                                        final_div_factor=1e4)  # fmt: skip
    for count in (0, 1, 2, 30, 57, 58, 100, 191, 192, 500):
        assert mil_vit.learning_rate(count, total_steps=192, max_lr=1e-4, div_factor=25.0) == pytest.approx(
            schedule(count), rel=1e-5, abs=1e-9)  # the port computes it in float32
    labels = torch.tensor([0, 1, 1, 1, 0, 1])
    assert torch.allclose(mil_vit.class_weights(labels, 2), torch.tensor([0.6, 0.3]) / 0.9)


@pytest.mark.parametrize("workload", ["mil_vit.train.wholeslide", "mil_vit.train.bag512"])
def test_training_steps_match_the_reference_tightly(workload):
    """On the CPU the port's steps are plain float32: the reference follows them to rounding."""
    cell = tiny_cell(workload, {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-4})
    result = run_cell(cell, 2**31 + 3, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"], result["checks"]

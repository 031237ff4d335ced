"""CHIEF slide encoder, in PyTorch.

Counterpart of ``stamp_tpu/encoding/encoder/chief.py:30-114``: CLAM-style
gated-attention pooling over CHIEF-CTransPath tile features.  Linear
768 → 512 + ReLU, gated attention 512 → 256 (tanh ⊙ sigmoid) → 1, a softmax
over tiles, and the attention-weighted sum of the *raw* features (CHIEF's
``WSI_feature``), in f32 on ``resolve_device(device)``.

Weights: ``STAMP_RANDOM_WEIGHTS=1`` draws them from
``np.random.default_rng(0)`` with the JAX package's distributions and in
its order, so CHIEF (and EAGLE, which scores tiles with it) is the same
network in both packages without a checkpoint.  Otherwise the published
``CHIEF_pretraining.pth`` (its ``attention_net.*`` entries) is loaded from
the local caches, and a missing one raises with the JAX package's guidance.
``chief_variables_from_jax`` / ``chief_variables_to_jax`` carry the JAX
package's flat parameter dict (``fc_w``, ``fc_b``, ``a_w`` …, weights
[out, in]) to this module's state dict and back.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder
from stamp_tpu_torch.models.towers import numpy_state_dict
from stamp_tpu_torch.preprocessing.config import ExtractorName
from stamp_tpu_torch.preprocessing.extractor import _find_torch_weights, _load_torch_state_dict
from stamp_tpu_torch.utils.device import resolve_device

_logger = logging.getLogger("stamp")

# this module's Linear layers; the JAX package's parameters are <layer>_w, <layer>_b
_LAYERS = ("fc", "a", "b", "c")


class ChiefAttentionNet(nn.Module):
    """The gated-attention net (CHIEF's size 'small': 768 → 512 → 256)."""

    def __init__(self) -> None:
        super().__init__()
        self.fc = nn.Linear(768, 512)
        self.a = nn.Linear(512, 256)
        self.b = nn.Linear(512, 256)
        self.c = nn.Linear(256, 1)

    def forward(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[N, 768] → the raw attention scores [N] and the pooled raw
        features [768]."""
        h = F.relu(self.fc(feats))
        attn_raw = self.c(torch.tanh(self.a(h)) * torch.sigmoid(self.b(h)))  # [N, 1]
        wsi_feature = torch.softmax(attn_raw.T, dim=1) @ feats  # [1, 768]
        return attn_raw[:, 0], wsi_feature[0]

    def scores_and_feature(self, feats: np.ndarray, device) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`forward` of ``feats`` on ``resolve_device(device)``, as f32
        numpy."""
        dev = resolve_device(device)
        self.to(dev)
        with torch.inference_mode():
            scores, feature = self(torch.as_tensor(np.asarray(feats, np.float32), device=dev))
        return scores.cpu().numpy(), feature.cpu().numpy()


def chief_variables_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's flat CHIEF parameters → this module's state dict."""
    return {
        f"{layer}.{kind}": torch.from_numpy(np.array(params[f"{layer}_{kind[0]}"], np.float32))
        for layer in _LAYERS
        for kind in ("weight", "bias")
    }


def chief_variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of :func:`chief_variables_from_jax` (numpy leaves)."""
    return {
        f"{layer}_{kind[0]}": state_dict[f"{layer}.{kind}"].detach().cpu().numpy()
        for layer in _LAYERS
        for kind in ("weight", "bias")
    }


def chief_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The published checkpoint's WSI gated-attention net (CLAM layout
    under ``attention_net``: the Linear stem at ``.0``, the gated attention
    at ``.3``) → this module's state dict (the JAX package's
    ``convert_chief_state_dict``, then :func:`chief_variables_from_jax`)."""
    sd = numpy_state_dict(state_dict)
    params = {
        "fc_w": sd["attention_net.0.weight"],
        "fc_b": sd["attention_net.0.bias"],
        "a_w": sd["attention_net.3.attention_a.0.weight"],
        "a_b": sd["attention_net.3.attention_a.0.bias"],
        "b_w": sd["attention_net.3.attention_b.0.weight"],
        "b_b": sd["attention_net.3.attention_b.0.bias"],
        "c_w": sd["attention_net.3.attention_c.weight"],
        "c_b": sd["attention_net.3.attention_c.bias"],
    }
    return chief_variables_from_jax(params)


def random_chief_params() -> dict[str, np.ndarray]:
    """The JAX package's random CHIEF parameters: ``default_rng(0)``
    normals of std 0.02 in its order, biases zero."""
    rng = np.random.default_rng(0)
    return {
        "fc_w": rng.normal(0, 0.02, (512, 768)).astype(np.float32),
        "fc_b": np.zeros(512, np.float32),
        "a_w": rng.normal(0, 0.02, (256, 512)).astype(np.float32),
        "a_b": np.zeros(256, np.float32),
        "b_w": rng.normal(0, 0.02, (256, 512)).astype(np.float32),
        "b_b": np.zeros(256, np.float32),
        "c_w": rng.normal(0, 0.02, (1, 256)).astype(np.float32),
        "c_b": np.zeros(1, np.float32),
    }


def load_chief_attention_net() -> ChiefAttentionNet:
    net = ChiefAttentionNet()
    if os.environ.get("STAMP_RANDOM_WEIGHTS") == "1":
        _logger.warning("CHIEF: using RANDOM weights (STAMP_RANDOM_WEIGHTS=1)")
        net.load_state_dict(chief_variables_from_jax(random_chief_params()))
        return net.eval()
    path = _find_torch_weights(["CHIEF_pretraining.pth", "*CHIEF*.pth"])
    if path is None:
        raise FileNotFoundError(
            "CHIEF weights not found. Pre-seed CHIEF_pretraining.pth into "
            "~/.cache/stamp or set STAMP_WEIGHTS_DIR "
            "(set STAMP_RANDOM_WEIGHTS=1 for smoke testing)."
        )
    net.load_state_dict(chief_state_dict(_load_torch_state_dict(path)))
    return net.eval()


class CHIEF(Encoder):
    def __init__(self) -> None:
        self.net = load_chief_attention_net()
        super().__init__(
            identifier=EncoderName.CHIEF_CTRANSPATH,
            precision="torch.float32",
            required_extractors=[ExtractorName.CHIEF_CTRANSPATH],
        )

    def _generate_slide_embedding(self, feats, device, **kwargs) -> np.ndarray:
        return self.net.scores_and_feature(feats, device)[1]

    def _generate_patient_embedding(self, feats_list, device, **kwargs) -> np.ndarray:
        return self.net.scores_and_feature(np.concatenate(feats_list, axis=0), device)[1]

"""What the non-ImageViT extractor towers share: their weights' layout,
their einsum attention, their random initialisation and their f32 mode.

The JAX package writes the CoCa, CLIP, Swin, BEiT3 and TICON towers
(``stamp_tpu/models/{coca,clip_vision,swin,beit3,ticon}.py``) as flax
modules.  Each tower of the port names its submodules and parameters after
that flax variable tree, so one rule carries a tree to a ``state_dict``
(:func:`state_dict_from_flax`):

* a Dense ``kernel`` [in, out] is a Linear (or ``QuantDense``) ``weight``
  [out, in]; a Conv ``kernel`` [kh, kw, in, out] is a Conv2d ``weight``
  [out, in, kh, kw];
* an int8 ``kernel_q`` [in, out] is ``weight_q`` [out, in];
* a LayerNorm ``scale`` is its ``weight``;
* every other leaf (biases, ``w_scale``, tokens, tables, and the
  ``act_stats`` collection's ``amax``) keeps its name, value and dtype.

Each tower's ``convert_*_state_dict`` (an upstream checkpoint → the port)
is the JAX package's converter, copied, followed by this rule.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

from stamp_tpu_torch.models.vit_image import QuantDense


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], Any]:
    out: dict[tuple[str, ...], Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out |= _flatten(value, prefix + (str(key),))
        else:
            out[prefix + (str(key),)] = value
    return out


def state_dict_from_flax(
    variables: Mapping[str, Any], collections: tuple[str, ...] = ("params", "act_stats")
) -> dict[str, torch.Tensor]:
    """A flax variable tree (numpy leaves) → the port tower's ``state_dict``
    by the rule of this module's docstring."""
    state: dict[str, torch.Tensor] = {}
    for collection in collections:
        for path, value in _flatten(variables.get(collection, {})).items():
            *module, leaf = path
            value = np.asarray(value)
            if leaf == "kernel":
                leaf, value = "weight", value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
            elif leaf == "kernel_q":
                leaf, value = "weight_q", value.T
            elif leaf == "scale":
                leaf = "weight"
            state[".".join([*module, leaf])] = torch.tensor(np.ascontiguousarray(value))
    return state


def numpy_state_dict(state_dict: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """An upstream checkpoint's tensors as numpy arrays (bf16 and f16 as
    f32), the leaves the copied converters read."""
    out = {}
    for key, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            value = value.float() if value.is_floating_point() else value
            value = value.numpy()
        out[key] = np.asarray(value)
    return out


def patchify(conv: nn.Conv2d, images_nhwc: torch.Tensor) -> torch.Tensor:
    """A strided patch convolution of NHWC images → [B, h·w, D], the
    patches in row-major order (flax's ``Conv`` then a reshape)."""
    return conv(images_nhwc.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H·d] → [B, H, N, d]."""
    b, n, dim = t.shape
    return t.reshape(b, n, num_heads, dim // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, N, d] → [B, N, H·d]."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def softmax_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    logit_divisor: float | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """``softmax(q·kᵀ [/ logit_divisor] [+ bias]) · v`` on [B, H, N, d], as
    the JAX towers' einsums compute it: the scores in f32 from the
    activation dtype's operands (``preferred_element_type=f32``), the bias
    added and the softmax taken in f32, the probabilities cast to ``v``'s
    dtype before their product with ``v``.  The caller scales ``q`` first
    where the JAX tower does."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if logit_divisor is not None:
        logits = logits / logit_divisor
    if bias is not None:
        logits = logits + bias.float()
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


@contextlib.contextmanager
def full_f32():
    """TF32 off for the f32 matmuls and convolutions inside, as the JAX
    package's ``jax.default_matmul_precision("highest")``; the flags are
    restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def init_random_weights_(
    model: nn.Module, generator: torch.Generator, params: Mapping[str, tuple[str, float]] | None = None
) -> nn.Module:
    """Random weights for benchmarking, drawn on the CPU from ``generator``
    in module order, with the flax towers' distributions: Dense and Conv
    kernels normal with std fan_in^-1/2, their biases zero, LayerNorm scales
    one and biases zero; a parameter of another kind is set by its name in
    ``params`` (``("normal", std)`` or ``("constant", value)``), else zero.
    The values differ from flax's: the two generators give other numbers."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)) or (
                isinstance(module, QuantDense) and module.mode != "int8"
            ):
                module.weight.normal_(0.0, module.weight[0].numel() ** -0.5, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            else:
                for name, param in module.named_parameters(recurse=False):
                    kind, value = (params or {}).get(name, ("constant", 0.0))
                    if kind == "normal":
                        param.normal_(0.0, value, generator=generator)
                    else:
                        param.fill_(value)
    return model

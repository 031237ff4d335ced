"""Reference-checkpoint interop: load and export KatherLab/STAMP Lightning
``.ckpt`` files.

Copy of ``stamp_tpu/modeling/interop.py`` for the port (it imports nothing
of the JAX package).  The reference saves Lightning checkpoints (a torch
zip archive holding ``hyper_parameters`` and a ``state_dict`` of
``model.*``-prefixed tensors) and re-instantiates models from those
hyper-parameters (reference deploy.py:49-58).  ``load_reference_checkpoint``
translates such a file into the task wrapper and the same variable tree an
npz ``model.ckpt`` holds (the JAX module's: transposed Dense kernels, the
per-head ALiBi projections fused, the Welford buffers in ``alibi_stats``),
so deploy, crossval and heatmaps take either file.  ``save_reference_
checkpoint`` / ``export_reference_checkpoint`` invert the mapping: the file
format, the key names, the hyper-parameters (``category_weights`` as
tensors, ``stamp_version`` a packaging ``Version``) and the version gate are
the JAX package's, so a ``.ckpt`` either package writes, the other reads.
Where the reference layout is the port's own ``state_dict`` (the Linear
head's ``fc``), the port's ``variables_to_jax`` / ``variables_from_jax``
map it.

Security: the files are pickle-based by construction, so they load with
``torch.load(weights_only=True)`` and a minimal allowlist (packaging
``Version``, pathlib paths); a checkpoint carrying other pickled objects is
refused naming the global.  There is no unsafe fallback.

Backbones: vit (with or without ALiBi), mlp, linear, trans_mil and barspoon.
"""

from __future__ import annotations

import logging
import pathlib
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch
from packaging.version import Version

import stamp_tpu_torch
from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
from stamp_tpu_torch.modeling.tasks import instantiate_from_hparams
from stamp_tpu_torch.models import mlp
from stamp_tpu_torch.models.barspoon import sanitize

_logger = logging.getLogger("stamp")

__all__ = [
    "is_reference_checkpoint",
    "load_reference_checkpoint",
    "save_reference_checkpoint",
    "export_reference_checkpoint",
]


def is_reference_checkpoint(path: Path | str) -> bool:
    """True if ``path`` is a torch-zip Lightning checkpoint (the reference's
    format) rather than an npz."""
    path = Path(path)
    if not zipfile.is_zipfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            return any(name.endswith("data.pkl") for name in zf.namelist())
    except (OSError, zipfile.BadZipFile):
        return False


def _load_torch_payload(path: Path) -> dict[str, Any]:
    import packaging.version

    # a pickled Version holds its parsed key, a ``_Version`` where packaging has one
    parsed_key = getattr(packaging.version, "_Version", None)
    allowlist = [Version, *([parsed_key] if parsed_key else []), pathlib.PosixPath, pathlib.WindowsPath,
                 pathlib.PurePosixPath]  # fmt: skip
    with torch.serialization.safe_globals(allowlist):
        try:
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:
            raise ValueError(
                f"{path} could not be loaded as a reference checkpoint in "
                "safe mode (weights_only=True). If it embeds custom pickled "
                "objects, re-export it from the reference as plain tensors "
                f"first. Loader said: {e}"
            ) from e
    if "state_dict" not in ckpt or "hyper_parameters" not in ckpt:
        raise ValueError(
            f"{path} is a torch archive but not a Lightning checkpoint "
            "(missing state_dict / hyper_parameters)"
        )
    return ckpt


def _np(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _plain(v: Any) -> Any:
    """hparams value → plain python (tensors, numpy, Version, Path)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, Path):
        return str(v)
    if v.__class__.__name__ == "Version":
        return str(v)
    return v


# ---------------------------------------------------------------------------
# State-dict conversion (torch layout → flax variable tree)
# ---------------------------------------------------------------------------


def _dense(sd: dict[str, np.ndarray], key: str) -> dict[str, np.ndarray]:
    """torch ``nn.Linear`` → flax Dense: weight [out, in] → kernel [in, out]."""
    out = {"kernel": np.ascontiguousarray(sd.pop(f"{key}.weight").T)}
    if f"{key}.bias" in sd:
        out["bias"] = sd.pop(f"{key}.bias")
    return out


def _layernorm(sd: dict[str, np.ndarray], key: str) -> dict[str, np.ndarray]:
    return {"scale": sd.pop(f"{key}.weight"), "bias": sd.pop(f"{key}.bias")}


def _fused_per_head(
    sd: dict[str, np.ndarray], prefix: str, n_heads: int
) -> dict[str, np.ndarray]:
    """Per-head ``nn.Linear`` list → one fused Dense whose output columns are
    the heads' blocks in order (kernel[:, h*hd:(h+1)*hd] = W_h.T)."""
    kernels = [sd.pop(f"{prefix}.{h}.weight").T for h in range(n_heads)]
    biases = [sd.pop(f"{prefix}.{h}.bias") for h in range(n_heads)]
    return {
        "kernel": np.ascontiguousarray(np.concatenate(kernels, axis=1)),
        "bias": np.concatenate(biases),
    }


def _convert_vit(
    sd: dict[str, np.ndarray], *, n_layers: int, n_heads: int, use_alibi: bool
) -> dict[str, Any]:
    """Reference VisionTransformer state dict → our flax variables.

    Layout per reference vision_tranformer.py: ``class_token``,
    ``project_features.0`` (Linear), per block ``transformer.layers.{i}.0``
    (SelfAttention: norm + mhsa) and ``.1`` (feed_forward Sequential:
    LayerNorm, Linear, GELU, Dropout, Linear, Dropout), ``transformer.norm``,
    ``mlp_head.0``.
    """
    params: dict[str, Any] = {
        "class_token": sd.pop("class_token"),
        "project": _dense(sd, "project_features.0"),
        "norm": _layernorm(sd, "transformer.norm"),
        "head": _dense(sd, "mlp_head.0"),
    }
    alibi_stats: dict[str, Any] = {}

    for i in range(n_layers):
        ref = f"transformer.layers.{i}"
        block: dict[str, Any] = {
            "attn_norm": _layernorm(sd, f"{ref}.0.norm"),
            "ff": {
                "norm": _layernorm(sd, f"{ref}.1.0"),
                "fc1": _dense(sd, f"{ref}.1.1"),
                "fc2": _dense(sd, f"{ref}.1.4"),
            },
        }
        if use_alibi:
            a = f"{ref}.0.mhsa"
            block["mhsa"] = {
                "q_proj": _fused_per_head(sd, f"{a}.query_encoders", n_heads),
                "k_proj": _fused_per_head(sd, f"{a}.key_encoders", n_heads),
                "v_proj": _fused_per_head(sd, f"{a}.value_encoders", n_heads),
                "fc": _dense(sd, f"{a}.fc"),
                "bias_scale": np.concatenate(
                    [sd.pop(f"{a}.attentions.{h}.bias_scale") for h in range(n_heads)]
                ),
            }
            alibi_stats[f"block_{i}"] = {
                "mhsa": {
                    "running_mean": np.concatenate(
                        [
                            sd.pop(f"{a}.attentions.{h}.scale_distance.running_mean")
                            for h in range(n_heads)
                        ]
                    ),
                    "items_so_far": np.concatenate(
                        [
                            sd.pop(f"{a}.attentions.{h}.scale_distance.items_so_far")
                            for h in range(n_heads)
                        ]
                    ),
                }
            }
        else:
            a = f"{ref}.0.mhsa"
            in_w = sd.pop(f"{a}.in_proj_weight")
            in_b = sd.pop(f"{a}.in_proj_bias")
            block["mhsa"] = {
                "in_proj": {
                    "kernel": np.ascontiguousarray(in_w.T),
                    "bias": in_b,
                },
                "out_proj": _dense(sd, f"{a}.out_proj"),
            }
        params[f"block_{i}"] = block

    variables: dict[str, Any] = {"params": params}
    if use_alibi:
        variables["alibi_stats"] = alibi_stats
    return variables


def _convert_mlp(sd: dict[str, np.ndarray], *, num_layers: int) -> dict[str, Any]:
    """Reference MLP (``mlp`` Sequential: Linear/ReLU/Dropout ×(n−1), final
    Linear) → our fc{i} + out Dense stack."""
    params: dict[str, Any] = {}
    for i in range(num_layers - 1):
        params[f"fc{i}"] = _dense(sd, f"mlp.{3 * i}")
    params["out"] = _dense(sd, f"mlp.{3 * (num_layers - 1)}")
    return {"params": params}


def _convert_linear(sd: dict[str, np.ndarray]) -> dict[str, Any]:
    """The reference Linear's state dict (``fc``) is the port's own:
    ``models.mlp.variables_to_jax`` maps it."""
    state = {k: torch.from_numpy(sd.pop(k)) for k in ("fc.weight", "fc.bias")}
    return mlp.variables_to_jax(state)


def _dwconv_in(sd: dict[str, np.ndarray], key: str) -> np.ndarray:
    """torch depthwise ``nn.Conv2d`` (groups=C) weight [C, 1, kh, kw] →
    flax HWIO kernel [kh, kw, 1, C]."""
    return np.ascontiguousarray(sd.pop(f"{key}.weight").transpose(2, 3, 1, 0))


def _convert_trans_mil(sd: dict[str, np.ndarray]) -> dict[str, Any]:
    """Reference TransMIL state dict → our flax variables.

    Layout per reference trans_mil.py:286-326: ``_fc1.0`` (Linear),
    ``cls_token``, two ``Transformer`` blocks (``layer{1,2}.norm`` +
    ``.attn`` NystromAttention: bias-free ``to_qkv``, ``to_out.0`` Linear,
    bias-free depthwise ``res_conv``), the ``pos_layer`` PPEG (depthwise
    7/5/3 convs with bias), final ``norm`` and ``_fc2``.
    """

    def attn_layer(name: str) -> dict[str, Any]:
        a = f"{name}.attn"
        return {
            "norm": _layernorm(sd, f"{name}.norm"),
            "attn": {
                "to_qkv": {
                    "kernel": np.ascontiguousarray(sd.pop(f"{a}.to_qkv.weight").T)
                },
                "to_out": _dense(sd, f"{a}.to_out.0"),
                "res_conv_kernel": _dwconv_in(sd, f"{a}.res_conv"),
            },
        }

    params: dict[str, Any] = {
        "fc1": _dense(sd, "_fc1.0"),
        "cls_token": sd.pop("cls_token"),
        "layer1": attn_layer("layer1"),
        "layer2": attn_layer("layer2"),
        "pos_layer": {
            "proj_kernel": _dwconv_in(sd, "pos_layer.proj"),
            "proj_bias": sd.pop("pos_layer.proj.bias"),
            "proj1_kernel": _dwconv_in(sd, "pos_layer.proj1"),
            "proj1_bias": sd.pop("pos_layer.proj1.bias"),
            "proj2_kernel": _dwconv_in(sd, "pos_layer.proj2"),
            "proj2_bias": sd.pop("pos_layer.proj2.bias"),
        },
        "norm": _layernorm(sd, "norm"),
        "fc2": _dense(sd, "_fc2"),
    }
    return {"params": params}


def _packed_mha_in(sd: dict[str, np.ndarray], key: str) -> dict[str, Any]:
    """torch ``nn.MultiheadAttention`` (packed ``in_proj_weight`` [3D, D] +
    ``out_proj``) → our barspoon ``_MHA`` tree ({q, k, v, out} Dense)."""
    w = sd.pop(f"{key}.in_proj_weight")
    b = sd.pop(f"{key}.in_proj_bias")
    d = w.shape[1]
    out: dict[str, Any] = {}
    for name, lo in (("q", 0), ("k", d), ("v", 2 * d)):
        out[name] = {
            "kernel": np.ascontiguousarray(w[lo : lo + d].T),
            "bias": b[lo : lo + d],
        }
    out["out"] = _dense(sd, f"{key}.out_proj")
    return out


def _convert_barspoon(
    sd: dict[str, np.ndarray],
    *,
    targets: list[str],
    num_encoder_layers: int,
    num_decoder_layers: int,
) -> dict[str, Any]:
    """Reference barspoon EncDecTransformer state dict → our flax variables.

    Layout per reference barspoon.py:104-162: ``projector.0`` (Linear),
    ``transformer_encoder.layers.{i}`` (torch TransformerEncoderLayer:
    packed-qkv self_attn, linear1/2, norm1/2), ``class_tokens.{sanitized}``
    ParameterDict, ``transformer_decoder.layers.{i}`` (DecoderLayer: adds
    ``multihead_attn`` cross attention and norm3), ``heads.{sanitized}``.
    """
    params: dict[str, Any] = {"projector": _dense(sd, "projector.0")}
    for i in range(num_encoder_layers):
        ref = f"transformer_encoder.layers.{i}"
        params[f"encoder_{i}"] = {
            "self_attn": _packed_mha_in(sd, f"{ref}.self_attn"),
            "norm1": _layernorm(sd, f"{ref}.norm1"),
            "norm2": _layernorm(sd, f"{ref}.norm2"),
            "ff1": _dense(sd, f"{ref}.linear1"),
            "ff2": _dense(sd, f"{ref}.linear2"),
        }
    for i in range(num_decoder_layers):
        ref = f"transformer_decoder.layers.{i}"
        params[f"decoder_{i}"] = {
            "self_attn": _packed_mha_in(sd, f"{ref}.self_attn"),
            "cross_attn": _packed_mha_in(sd, f"{ref}.multihead_attn"),
            "norm1": _layernorm(sd, f"{ref}.norm1"),
            "norm2": _layernorm(sd, f"{ref}.norm2"),
            "norm3": _layernorm(sd, f"{ref}.norm3"),
            "ff1": _dense(sd, f"{ref}.linear1"),
            "ff2": _dense(sd, f"{ref}.linear2"),
        }
    for t in targets:
        s = sanitize(t)
        params[f"class_token_{s}"] = sd.pop(f"class_tokens.{s}")
        params[f"head_{s}"] = _dense(sd, f"heads.{s}")
    return {"params": params}


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

# hparams the reference stores but this framework re-derives or ignores
_DROPPED_HPARAMS = {"model_class"}


def load_reference_checkpoint(path: Path | str):
    """Load a reference Lightning ``model.ckpt`` → (TaskModel, variables).

    Mirrors the reference's own re-instantiation contract
    (deploy.py:49-58): everything the model needs is in
    ``hyper_parameters``; the version gate (<2.5.0 or >installed rejected)
    runs through the task wrapper exactly as for native checkpoints.
    """
    path = Path(path)
    ckpt = _load_torch_payload(path)
    hp = {str(k): _plain(v) for k, v in ckpt["hyper_parameters"].items()}

    model_name = str(hp.get("model_name", ""))
    if model_name not in ("vit", "mlp", "linear", "trans_mil", "barspoon"):
        raise ValueError(
            f"reference checkpoint interop supports vit/mlp/linear/trans_mil/"
            f"barspoon backbones; this checkpoint uses {model_name!r}. "
            "Re-train with this framework (or export the model as an npz "
            "checkpoint) instead."
        )

    # model.* weights; anything else (class_weights buffer, torchmetrics
    # state) is wrapper state this framework rebuilds from hparams
    sd = {
        k[len("model.") :]: _np(v)
        for k, v in ckpt["state_dict"].items()
        if k.startswith("model.")
    }
    ignored = [k for k in ckpt["state_dict"] if not k.startswith("model.")]
    if ignored:
        _logger.debug(f"interop: ignoring non-backbone state entries {ignored}")

    our_hp = {k: v for k, v in hp.items() if k not in _DROPPED_HPARAMS}
    model = instantiate_from_hparams(our_hp)

    if model_name == "vit":
        variables = _convert_vit(
            sd,
            n_layers=int(hp.get("n_layers", 2)),
            n_heads=int(hp.get("n_heads", 8)),
            use_alibi=bool(hp.get("use_alibi", False)),
        )
    elif model_name == "mlp":
        variables = _convert_mlp(sd, num_layers=int(hp.get("num_layers", 2)))
    elif model_name == "trans_mil":
        variables = _convert_trans_mil(sd)
    elif model_name == "barspoon":
        variables = _convert_barspoon(
            sd,
            targets=list(hp["category_weights"].keys()),
            num_encoder_layers=int(hp.get("num_encoder_layers", 2)),
            num_decoder_layers=int(hp.get("num_decoder_layers", 2)),
        )
    else:
        variables = _convert_linear(sd)

    if sd:
        raise ValueError(
            f"reference checkpoint has unconsumed backbone weights: "
            f"{sorted(sd)} — architecture mismatch between the checkpoint "
            "hparams and its state dict"
        )
    _logger.info(
        f"loaded reference Lightning checkpoint {path.name} "
        f"({model_name}, task={hp.get('task')})"
    )
    return model, variables


# ---------------------------------------------------------------------------
# Export: flax variable tree → reference Lightning checkpoint
# ---------------------------------------------------------------------------


def _t(arr: np.ndarray) -> Any:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))


def _dense_out(sd: dict[str, Any], key: str, dense: dict[str, Any]) -> None:
    """flax Dense → torch ``nn.Linear``: kernel [in, out] → weight [out, in]."""
    sd[f"{key}.weight"] = _t(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        sd[f"{key}.bias"] = _t(dense["bias"])


def _layernorm_out(sd: dict[str, Any], key: str, ln: dict[str, Any]) -> None:
    sd[f"{key}.weight"] = _t(ln["scale"])
    sd[f"{key}.bias"] = _t(ln["bias"])


def _split_per_head(
    sd: dict[str, Any], prefix: str, fused: dict[str, Any], n_heads: int
) -> None:
    """One fused Dense → the reference's per-head ``nn.Linear`` list
    (inverse of ``_fused_per_head``: W_h = kernel[:, h*hd:(h+1)*hd].T)."""
    kernel = np.asarray(fused["kernel"])
    bias = np.asarray(fused["bias"])
    hd = kernel.shape[1] // n_heads
    for h in range(n_heads):
        sd[f"{prefix}.{h}.weight"] = _t(kernel[:, h * hd : (h + 1) * hd].T)
        sd[f"{prefix}.{h}.bias"] = _t(bias[h * hd : (h + 1) * hd])


def _export_vit(
    variables: dict[str, Any], *, n_layers: int, n_heads: int, use_alibi: bool
) -> dict[str, Any]:
    """Inverse of ``_convert_vit`` — emits the reference VisionTransformer
    state-dict key layout (reference vision_tranformer.py)."""
    params = variables["params"]
    sd: dict[str, Any] = {"class_token": _t(params["class_token"])}
    _dense_out(sd, "project_features.0", params["project"])
    _layernorm_out(sd, "transformer.norm", params["norm"])
    _dense_out(sd, "mlp_head.0", params["head"])

    for i in range(n_layers):
        block = params[f"block_{i}"]
        ref = f"transformer.layers.{i}"
        _layernorm_out(sd, f"{ref}.0.norm", block["attn_norm"])
        _layernorm_out(sd, f"{ref}.1.0", block["ff"]["norm"])
        _dense_out(sd, f"{ref}.1.1", block["ff"]["fc1"])
        _dense_out(sd, f"{ref}.1.4", block["ff"]["fc2"])
        a = f"{ref}.0.mhsa"
        if use_alibi:
            mhsa = block["mhsa"]
            _split_per_head(sd, f"{a}.query_encoders", mhsa["q_proj"], n_heads)
            _split_per_head(sd, f"{a}.key_encoders", mhsa["k_proj"], n_heads)
            _split_per_head(sd, f"{a}.value_encoders", mhsa["v_proj"], n_heads)
            _dense_out(sd, f"{a}.fc", mhsa["fc"])
            bias_scale = np.asarray(mhsa["bias_scale"])
            stats = variables["alibi_stats"][f"block_{i}"]["mhsa"]
            running_mean = np.asarray(stats["running_mean"])
            items_so_far = np.asarray(stats["items_so_far"])
            for h in range(n_heads):
                sd[f"{a}.attentions.{h}.bias_scale"] = _t(bias_scale[h : h + 1])
                sd[f"{a}.attentions.{h}.scale_distance.running_mean"] = _t(
                    running_mean[h : h + 1]
                )
                sd[f"{a}.attentions.{h}.scale_distance.items_so_far"] = _t(
                    items_so_far[h : h + 1]
                )
        else:
            mhsa = block["mhsa"]
            sd[f"{a}.in_proj_weight"] = _t(np.asarray(mhsa["in_proj"]["kernel"]).T)
            sd[f"{a}.in_proj_bias"] = _t(mhsa["in_proj"]["bias"])
            _dense_out(sd, f"{a}.out_proj", mhsa["out_proj"])
    return sd


def _export_mlp(variables: dict[str, Any], *, num_layers: int) -> dict[str, Any]:
    params = variables["params"]
    sd: dict[str, Any] = {}
    for i in range(num_layers - 1):
        _dense_out(sd, f"mlp.{3 * i}", params[f"fc{i}"])
    _dense_out(sd, f"mlp.{3 * (num_layers - 1)}", params["out"])
    return sd


def _export_linear(variables: dict[str, Any]) -> dict[str, Any]:
    """The port's Linear ``state_dict`` is the reference's."""
    return mlp.variables_from_jax(variables)


def _dwconv_out(sd: dict[str, Any], key: str, kernel: np.ndarray) -> None:
    """flax HWIO depthwise kernel [kh, kw, 1, C] → torch [C, 1, kh, kw]."""
    sd[f"{key}.weight"] = _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _export_trans_mil(variables: dict[str, Any]) -> dict[str, Any]:
    """Inverse of ``_convert_trans_mil``."""
    params = variables["params"]
    sd: dict[str, Any] = {"cls_token": _t(params["cls_token"])}
    _dense_out(sd, "_fc1.0", params["fc1"])
    _layernorm_out(sd, "norm", params["norm"])
    _dense_out(sd, "_fc2", params["fc2"])
    for name in ("layer1", "layer2"):
        layer = params[name]
        _layernorm_out(sd, f"{name}.norm", layer["norm"])
        attn = layer["attn"]
        sd[f"{name}.attn.to_qkv.weight"] = _t(
            np.asarray(attn["to_qkv"]["kernel"]).T
        )
        _dense_out(sd, f"{name}.attn.to_out.0", attn["to_out"])
        _dwconv_out(sd, f"{name}.attn.res_conv", attn["res_conv_kernel"])
    pos = params["pos_layer"]
    for torch_name, ours in (("proj", "proj"), ("proj1", "proj1"), ("proj2", "proj2")):
        _dwconv_out(sd, f"pos_layer.{torch_name}", pos[f"{ours}_kernel"])
        sd[f"pos_layer.{torch_name}.bias"] = _t(pos[f"{ours}_bias"])
    return sd


def _packed_mha_out(sd: dict[str, Any], key: str, mha: dict[str, Any]) -> None:
    """Inverse of ``_packed_mha_in``: {q, k, v, out} Dense → torch
    ``nn.MultiheadAttention`` packed ``in_proj_weight``/``in_proj_bias``."""
    sd[f"{key}.in_proj_weight"] = _t(
        np.concatenate(
            [np.asarray(mha[n]["kernel"]).T for n in ("q", "k", "v")], axis=0
        )
    )
    sd[f"{key}.in_proj_bias"] = _t(
        np.concatenate([np.asarray(mha[n]["bias"]) for n in ("q", "k", "v")])
    )
    _dense_out(sd, f"{key}.out_proj", mha["out"])


def _export_barspoon(
    variables: dict[str, Any],
    *,
    targets: list[str],
    num_encoder_layers: int,
    num_decoder_layers: int,
) -> dict[str, Any]:
    """Inverse of ``_convert_barspoon`` — emits the reference
    EncDecTransformer state-dict key layout (reference barspoon.py:104-162)."""
    params = variables["params"]
    sd: dict[str, Any] = {}
    _dense_out(sd, "projector.0", params["projector"])
    for i in range(num_encoder_layers):
        block = params[f"encoder_{i}"]
        ref = f"transformer_encoder.layers.{i}"
        _packed_mha_out(sd, f"{ref}.self_attn", block["self_attn"])
        _layernorm_out(sd, f"{ref}.norm1", block["norm1"])
        _layernorm_out(sd, f"{ref}.norm2", block["norm2"])
        _dense_out(sd, f"{ref}.linear1", block["ff1"])
        _dense_out(sd, f"{ref}.linear2", block["ff2"])
    for i in range(num_decoder_layers):
        block = params[f"decoder_{i}"]
        ref = f"transformer_decoder.layers.{i}"
        _packed_mha_out(sd, f"{ref}.self_attn", block["self_attn"])
        _packed_mha_out(sd, f"{ref}.multihead_attn", block["cross_attn"])
        _layernorm_out(sd, f"{ref}.norm1", block["norm1"])
        _layernorm_out(sd, f"{ref}.norm2", block["norm2"])
        _layernorm_out(sd, f"{ref}.norm3", block["norm3"])
        _dense_out(sd, f"{ref}.linear1", block["ff1"])
        _dense_out(sd, f"{ref}.linear2", block["ff2"])
    for t in targets:
        s = sanitize(t)
        sd[f"class_tokens.{s}"] = _t(params[f"class_token_{s}"])
        _dense_out(sd, f"heads.{s}", params[f"head_{s}"])
    return sd


def _torchify_hparams(hp: dict[str, Any]) -> dict[str, Any]:
    """Repo hparams → the reference's hyper_parameters conventions:
    ``category_weights`` as a torch tensor, ``stamp_version`` as a
    packaging ``Version`` (what Lightning pickles on the reference side)."""
    out = {k: v for k, v in hp.items() if k != "model_class" and v is not None}
    if "category_weights" in out:
        cw = out["category_weights"]
        if isinstance(cw, dict):  # barspoon: per-target weight tensors
            out["category_weights"] = {
                str(k): torch.as_tensor(np.asarray(v, dtype=np.float32))
                for k, v in cw.items()
            }
        else:
            out["category_weights"] = torch.as_tensor(
                np.asarray(cw, dtype=np.float32)
            )
    out["stamp_version"] = Version(
        str(out.get("stamp_version", stamp_tpu_torch.__version__))
    )
    return out


def save_reference_checkpoint(
    path: Path | str, *, hyper_parameters: dict[str, Any], variables: Any
) -> None:
    """Write a Lightning ``.ckpt`` the reference pipeline can deploy.

    Inverts the load-direction conversion: the flax variable tree becomes a
    ``model.*``-prefixed torch state dict in the reference's exact key
    layout, hparams become ``hyper_parameters``.  The reference's
    ``load_model_from_ckpt`` (deploy.py:49-58) re-instantiates from these
    hparams and loads the state dict strictly, so the export must consume
    the full tree (``tests/test_torch_interop.py`` holds the round trip).
    """
    path = Path(path)
    hp = dict(hyper_parameters)
    model_name = str(hp.get("model_name", ""))
    if model_name == "vit":
        sd = _export_vit(
            variables,
            n_layers=int(hp.get("n_layers", 2)),
            n_heads=int(hp.get("n_heads", 8)),
            use_alibi=bool(hp.get("use_alibi", False)),
        )
    elif model_name == "mlp":
        sd = _export_mlp(variables, num_layers=int(hp.get("num_layers", 2)))
    elif model_name == "linear":
        sd = _export_linear(variables)
    elif model_name == "trans_mil":
        sd = _export_trans_mil(variables)
    elif model_name == "barspoon":
        sd = _export_barspoon(
            variables,
            targets=list(hp["category_weights"].keys()),
            num_encoder_layers=int(hp.get("num_encoder_layers", 2)),
            num_decoder_layers=int(hp.get("num_decoder_layers", 2)),
        )
    else:
        raise ValueError(
            f"reference checkpoint export supports vit/mlp/linear/trans_mil/"
            f"barspoon backbones; got {model_name!r}."
        )

    ckpt = {
        "state_dict": {f"model.{k}": v for k, v in sd.items()},
        "hyper_parameters": _torchify_hparams(hp),
        "epoch": 0,
        "global_step": int(hp.get("total_steps", 0)),
        # Lightning's checkpoint migration reads this key unconditionally
        "pytorch-lightning_version": "2.5.0",
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(ckpt, tmp)
    tmp.rename(path)
    _logger.info(
        f"exported reference Lightning checkpoint {path.name} ({model_name})"
    )


def export_reference_checkpoint(src: Path | str, dst: Path | str) -> None:
    """Convert an npz ``model.ckpt`` into a reference Lightning ``.ckpt``
    (the other direction of ``load_reference_checkpoint``)."""
    ckpt = load_checkpoint(src)
    save_reference_checkpoint(
        Path(dst),
        hyper_parameters=ckpt["hyper_parameters"],
        variables=ckpt["variables"],
    )

"""The port's other extractor families against the JAX package's, on the CPU.

* Each tower (CoCa, CLIP, Swin, BEiT3, the TICON encoder; KEEP's head):
  flax random init → ``towers.state_dict_from_flax`` → the port's forward,
  against the JAX forward on the same numpy inputs, in f32 at atol 1e-3 (as
  ``tests/test_torch_vit_image.py``), and the int8 tree (quantized params and
  calibrated ``act_stats``) through the same rule.
* Each upstream-checkpoint converter against its JAX counterpart on a
  synthetic checkpoint (the independent torch oracles of
  ``tests/test_converter_parity.py``, HF ``CLIPModel``, and inverse maps
  written here): the same state, bitwise.
* Each family's extractor, reduced in width and depth, on the same
  checkpoint and tiles through both packages' factories, bf16 and int8.
* ``python -m stamp_tpu_torch preprocess`` against ``python -m stamp_tpu
  preprocess`` on a synthetic slide for a reduced CONCH and for Swin, and
  every ``ExtractorName`` resolving.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from stamp_tpu.models import beit3 as jax_beit3
from stamp_tpu.models import clip_vision as jax_clip
from stamp_tpu.models import coca as jax_coca
from stamp_tpu.models import swin as jax_swin
from stamp_tpu.models import ticon as jax_ticon
from stamp_tpu.models import vit_image as jax_vit
from stamp_tpu_torch.models import beit3, clip_vision, coca, swin, ticon, towers
from stamp_tpu_torch.models import vit_image as torch_vit
from stamp_tpu_torch.ops import flash_attention as torch_attn
from stamp_tpu_torch.ops import ln_dense as torch_lnd

CPU = torch.device("cpu")

_COCA = dict(img_size=32, patch_size=16, width=32, depth=2, num_heads=2, pooled_dim=16, pool_heads=4)
_CLIP = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=4, mlp_dim=64, projection_dim=16)
_BEIT3 = dict(img_size=32, patch_size=16, width=32, depth=2, num_heads=4)
# 56 px: stage 0 at 14² tokens (two 7² windows a side, shifted in block 1),
# stage 1 at 7² (one window, unshifted)
_SWIN = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window=7)
_TICON = dict(embed_dim=32, depth=2, num_heads=4, in_dim=24)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(size: int, batch: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(batch, size, size, 3)).astype(np.float32)


def _ticon_inputs(batch: int = 2, n: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, n, _TICON["in_dim"])).astype(np.float32)
    coords = rng.uniform(0, 4, size=(batch, n, 2)).astype(np.float32)
    return feats, coords


@dataclasses.dataclass(frozen=True)
class _Tower:
    """A tower in both packages: ``jax(quant)`` and ``port(quant)`` build it,
    ``inputs()`` gives numpy inputs, ``jax_apply`` / ``port_apply`` run it
    (MUSK's two scales), ``sites`` are the JAX package's QuantDense paths."""

    jax: object
    port: object
    inputs: object
    sites: list
    jax_apply: object = None
    port_apply: object = None


_TOWERS = {
    "coca": _Tower(
        jax=lambda q: jax_coca.CoCaVisionTower(jax_coca.CoCaVisionConfig(**_COCA, quant=q)),
        port=lambda q: coca.CoCaVisionTower(coca.CoCaVisionConfig(**_COCA, quant=q)),
        inputs=lambda seed=0: (_images(32, seed=seed),),
        sites=jax_vit.vit_quant_sites(2),
    ),
    "clip": _Tower(
        jax=lambda q: jax_clip.CLIPVisionTower(jax_clip.CLIPVisionConfig(**_CLIP, quant=q)),
        port=lambda q: clip_vision.CLIPVisionTower(clip_vision.CLIPVisionConfig(**_CLIP, quant=q)),
        inputs=lambda seed=0: (_images(32, seed=seed),),
        sites=jax_clip.clip_quant_sites(2),
    ),
    "beit3": _Tower(
        jax=lambda q: jax_beit3.Beit3VisionTower(jax_beit3.Beit3Config(**_BEIT3, quant=q)),
        port=lambda q: beit3.Beit3VisionTower(beit3.Beit3Config(**_BEIT3, quant=q)),
        inputs=lambda seed=0: (_images(32, seed=seed),),
        sites=jax_beit3.beit3_quant_sites(2),
        jax_apply=lambda module, variables, x: jax_beit3.multiscale_cls(module, variables, x),
        port_apply=beit3.multiscale_cls,
    ),
    "swin": _Tower(
        jax=lambda q: jax_swin.SwinTransformer(**_SWIN, quant=q),
        port=lambda q: swin.SwinTransformer(**_SWIN, quant=q),
        inputs=lambda seed=0: (_images(56, seed=seed),),
        sites=jax_swin.swin_quant_sites(_SWIN["depths"]),
    ),
    "ticon": _Tower(
        jax=lambda q: jax_ticon.TiconEncoder(**_TICON, quant=q),
        port=lambda q: ticon.TiconEncoder(**_TICON, quant=q),
        inputs=lambda seed=0: _ticon_inputs(seed=seed),
        sites=jax_ticon.ticon_quant_sites(2),
    ),
}


def _jax_run(tower: _Tower, module, variables, inputs):
    args = [jnp.asarray(a) for a in inputs]
    apply = functools.partial(tower.jax_apply, module) if tower.jax_apply is not None else module.apply
    return np.asarray(jax.jit(apply)(variables, *args).astype(jnp.float32))


def _port_run(tower: _Tower, model, inputs, dtype=torch.float32):
    args = [torch.from_numpy(a).to(dtype) for a in inputs]
    with torch.inference_mode():
        if tower.port_apply is not None:
            return tower.port_apply(model, *args).float().numpy()
        return model(*args).float().numpy()


def _port_model(tower: _Tower, quant: str, variables) -> torch.nn.Module:
    model = tower.port(quant).eval()
    model.load_state_dict(towers.state_dict_from_flax(variables))  # strict
    return model


@functools.cache
def _jax_variables(name: str) -> dict:
    tower = _TOWERS[name]
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        return _np_tree(jax.jit(tower.jax("off").init)(jax.random.PRNGKey(0), *map(jnp.asarray, tower.inputs())))


@pytest.mark.parametrize("name", sorted(_TOWERS))
def test_tower_matches_jax_f32(name):
    tower = _TOWERS[name]
    variables = _jax_variables(name)
    inputs = tower.inputs(seed=1)
    want = _jax_run(tower, tower.jax("off"), variables, inputs)
    got = _port_run(tower, _port_model(tower, "off", variables), inputs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


def _bf16_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


# bf16 through both packages (weights and inputs cast as each extractor casts
# them): each rounds at different places, so the outputs agree to a few bf16
# steps.  Measured max |Δ| / max |ref| ≤ 1.43e-2 (ticon; 6.8e-3 coca, 1.15e-2
# clip, 1.25e-2 beit3) and per-row cosine ≥ 0.99989; the limits are 3e-2 and
# 0.999.
BF16_REL_TOL = 3e-2
BF16_COSINE_MIN = 0.999


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.reshape(len(a), -1).astype(np.float64), b.reshape(len(b), -1).astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("name", sorted(set(_TOWERS) - {"swin"}))
def test_tower_matches_jax_bf16(name):
    """Swin runs in f32 in both packages (its extractors cast nothing)."""
    tower = _TOWERS[name]
    variables = _jax_variables(name)
    inputs = tower.inputs(seed=2)
    bf16_inputs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in inputs]
    want = _jax_run(tower, tower.jax("off"), _bf16_tree(variables), bf16_inputs)
    model = _port_model(tower, "off", variables).to(torch.bfloat16)
    got = _port_run(tower, model, inputs, dtype=torch.bfloat16)
    assert np.abs(got - want).max() <= BF16_REL_TOL * np.abs(want).max()
    assert _cosine(got, want).min() >= BF16_COSINE_MIN


# W8A8 on the same quantized weights and calibrated scales in f32 activations:
# the packages' activations agree to a few ulps before each quantize, so a
# value within those ulps of a half-integer of the int8 grid can round either
# way (ROADMAP Queue C, cross-framework int8 rounding); one step at one site
# moves these small towers' outputs by up to a few 1e-3.  Measured max |Δ| /
# max |ref| ≤ 7.5e-7 on these seeds (no value at a tie); the limit 1e-2
# allows such a step.
INT8_REL_TOL = 1e-2


@pytest.mark.parametrize("name", sorted(_TOWERS))
def test_tower_int8_matches_jax(name):
    """The JAX package's int8 tree (``quantize_sites`` and an observe pass's
    ``act_stats``) carried over by the same rule, against its int8 forward;
    and the port's own calibration and quantization against the JAX
    package's on the same weights and inputs."""
    tower = _TOWERS[name]
    variables = _jax_variables(name)
    calib = tower.inputs(seed=3)
    observe = functools.partial(tower.jax("observe").apply, mutable=["act_stats"])
    _, mut = jax.jit(observe)(variables, *map(jnp.asarray, calib))
    qvars = {"params": jax_vit.quantize_sites(variables["params"], tower.sites), "act_stats": mut["act_stats"]}
    qvars = _np_tree(qvars)
    inputs = tower.inputs(seed=4)
    want = _jax_run(tower, tower.jax("int8"), qvars, inputs)
    got = _port_run(tower, _port_model(tower, "int8", qvars), inputs)
    assert np.abs(got - want).max() <= INT8_REL_TOL * np.abs(want).max()

    # the port's calibration and quantization give the same int8 state
    observe = _port_model(tower, "observe", variables)
    act_stats = torch_vit.calibrate_act_stats(observe, *(torch.from_numpy(a) for a in calib))
    port_sites = [".".join(site) for site in tower.sites]
    qstate = torch_vit.quantize_sites(observe.state_dict(), port_sites)
    want_state = towers.state_dict_from_flax(qvars)
    assert set(qstate) | set(act_stats) == set(want_state)
    for site in port_sites:
        torch.testing.assert_close(qstate[f"{site}.weight_q"], want_state[f"{site}.weight_q"], rtol=0, atol=0)
        torch.testing.assert_close(qstate[f"{site}.w_scale"], want_state[f"{site}.w_scale"], rtol=0, atol=1e-7)
        assert act_stats[f"{site}.amax"].item() == pytest.approx(want_state[f"{site}.amax"].item(), rel=1e-5)


def test_keep_head_matches_jax():
    """KEEP's head (f32 Linear → GELU → Linear → ℓ2) against the JAX
    package's formula (``clip_like.py:_head_proj``) on the same weights."""
    rng = np.random.default_rng(0)
    head = {"w0": rng.normal(0, 0.02, (8, 12)), "b0": rng.normal(0, 0.1, 8),
            "w2": rng.normal(0, 0.02, (8, 8)), "b2": rng.normal(0, 0.1, 8)}  # fmt: skip
    head = {k: v.astype(np.float32) for k, v in head.items()}
    feats = rng.normal(size=(3, 12)).astype(np.float32)
    h = jnp.asarray(feats) @ head["w0"].T + head["b0"]
    h = jax.nn.gelu(h, approximate=False) @ head["w2"].T + head["b2"]
    want = np.asarray(h / jnp.linalg.norm(h, axis=-1, keepdims=True))

    from stamp_tpu_torch.preprocessing.extractor.clip_like import KeepHead, keep_head_state_dict

    model = KeepHead(12, 8)
    model.load_state_dict({k.removeprefix("head."): v for k, v in keep_head_state_dict(head).items()})
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_state_dict_from_flax_names_every_parameter():
    """The rule gives exactly each port tower's parameters, in every mode."""
    for name, tower in _TOWERS.items():
        for quant in ("off", "int8"):
            with torch.device("meta"):
                keys = set(tower.port(quant).state_dict())
            variables = _jax_variables(name)
            if quant == "int8":
                variables = {
                    "params": jax_vit.quantize_sites(variables["params"], tower.sites),
                    "act_stats": {},
                }
                amax = {".".join(site) + ".amax" for site in tower.sites}
            else:
                amax = set()
            assert set(towers.state_dict_from_flax(variables)) | amax == keys, (name, quant)


# --- upstream checkpoints → the port, against the JAX package's converters ----------


def _perturbed(tree, seed: int = 0):
    """The tree with every leaf moved by noise, so that ones and zeros of the
    initializers (LayerNorm, gammas, BatchNorm statistics) carry over too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), _np_tree(tree))


# Swin reduced in width (the converter fixes the depths 2, 2, 6, 2 and the
# extractor the 224 px input): dims 16 → 128, heads of width 8
_SWIN_REDUCED = dict(embed_dim=16, num_heads=(2, 4, 8, 16))
_TICON_REDUCED = dict(embed_dim=32, num_heads=4, in_dim=32)  # depth 6, as the converter reads


def _ctranspath_checkpoint(params) -> dict[str, np.ndarray]:
    """The inverse of ``convert_ctranspath_state_dict``: CTransPath's
    layout (timm Swin names, the stem as a Sequential)."""
    def lin(prefix, leaf, bias=True):
        out = {f"{prefix}.weight": leaf["kernel"].T}
        return out | ({f"{prefix}.bias": leaf["bias"]} if bias else {})

    def ln(prefix, leaf):
        return {f"{prefix}.weight": leaf["scale"], f"{prefix}.bias": leaf["bias"]}

    stem = params["patch_embed"]
    sd = {}
    for i, (conv, bn) in enumerate([(0, 1), (3, 4)]):
        sd[f"patch_embed.proj.{conv}.weight"] = stem[f"conv{i}"]["kernel"].transpose(3, 2, 0, 1)
        sd[f"patch_embed.proj.{bn}.weight"] = stem[f"bn{i}_scale"]
        sd[f"patch_embed.proj.{bn}.bias"] = stem[f"bn{i}_bias"]
        sd[f"patch_embed.proj.{bn}.running_mean"] = stem[f"bn{i}_mean"]
        sd[f"patch_embed.proj.{bn}.running_var"] = 1.0 + np.abs(stem[f"bn{i}_var"] - 1.0)
    sd["patch_embed.proj.6.weight"] = stem["proj"]["kernel"].transpose(3, 2, 0, 1)
    sd["patch_embed.proj.6.bias"] = stem["proj"]["bias"]
    sd |= ln("patch_embed.norm", stem["norm"]) | ln("norm", params["norm"])
    for stage, depth in enumerate((2, 2, 6, 2)):
        for blk in range(depth):
            leaf, p = params[f"stage{stage}_block{blk}"], f"layers.{stage}.blocks.{blk}."
            sd |= ln(p + "norm1", leaf["norm1"]) | ln(p + "norm2", leaf["norm2"])
            sd[p + "attn.relative_position_bias_table"] = leaf["attn"]["relative_position_bias_table"]
            sd |= lin(p + "attn.qkv", leaf["attn"]["qkv"]) | lin(p + "attn.proj", leaf["attn"]["proj"])
            sd |= lin(p + "mlp.fc1", leaf["mlp_fc1"]) | lin(p + "mlp.fc2", leaf["mlp_fc2"])
        if stage < 3:
            leaf, p = params[f"stage{stage}_downsample"], f"layers.{stage}.downsample."
            sd |= ln(p + "norm", leaf["norm"]) | lin(p + "reduction", leaf["reduction"], bias=False)
    return sd


def _ticon_checkpoint(params) -> dict[str, np.ndarray]:
    """The inverse of ``convert_ticon_state_dict``, under the ``backbone.``
    prefix of a TICON training checkpoint."""
    def lin(prefix, leaf):
        return {f"{prefix}.weight": leaf["kernel"].T, f"{prefix}.bias": leaf["bias"]}

    def ln(prefix, leaf):
        return {f"{prefix}.weight": leaf["scale"], f"{prefix}.bias": leaf["bias"]}

    ip = "input_proj_dict.input_proj_hoptimus1."
    proj = params["input_proj"]
    sd = lin(ip + "fc1", proj["fc1"]) | lin(ip + "fc2", proj["fc2"]) | ln(ip + "norm", proj["norm"])
    sd |= ln("enc_norm", params["enc_norm"])
    for i in range(6):
        leaf, p = params[f"block_{i}"], f"encoder.blocks.{i}."
        sd[p + "residual1.gamma"], sd[p + "residual2.gamma"] = leaf["gamma1"], leaf["gamma2"]
        sd |= ln(p + "residual1.norm", leaf["norm1"]) | ln(p + "residual2.norm", leaf["norm2"])
        for name in ("q_proj", "k_proj", "v_proj", "proj"):
            sd |= lin(p + f"residual1.fn.{name}", leaf["attn"][name])
        sd |= lin(p + "residual2.fn.fc1", leaf["mlp"]["fc1"]) | lin(p + "residual2.fn.fc2", leaf["mlp"]["fc2"])
    return {f"backbone.{k}": v for k, v in sd.items()}


def _init_params(module, *inputs, seed: int = 0):
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        return _perturbed(jax.jit(module.init)(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))["params"], seed)


@functools.cache
def _coca_checkpoint():
    from test_converter_parity import _TorchCoCaTower

    torch.manual_seed(0)
    return _TorchCoCaTower(jax_coca.CoCaVisionConfig(**_COCA)).checkpoint()


@functools.cache
def _beit3_checkpoint():
    from test_converter_parity import _TorchBeit3Tower

    torch.manual_seed(0)
    return _TorchBeit3Tower(jax_beit3.Beit3Config(**_BEIT3)).checkpoint()


@functools.cache
def _clip_checkpoint():
    from transformers import CLIPConfig, CLIPModel

    torch.manual_seed(0)
    hf = CLIPModel(CLIPConfig(
        text_config=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=1, num_attention_heads=2),
        vision_config=dict(hidden_size=_CLIP["embed_dim"], intermediate_size=_CLIP["mlp_dim"],
                           num_hidden_layers=_CLIP["depth"], num_attention_heads=_CLIP["num_heads"],
                           image_size=_CLIP["img_size"], patch_size=_CLIP["patch_size"],
                           hidden_act="quick_gelu"),
        projection_dim=_CLIP["projection_dim"],
    ))  # fmt: skip
    return {k: v.numpy() for k, v in hf.state_dict().items()}


@functools.cache
def _swin_checkpoint():
    params = _init_params(jax_swin.SwinTransformer(**_SWIN_REDUCED), np.zeros((1, 224, 224, 3), np.float32))
    return _ctranspath_checkpoint(params)


@functools.cache
def _ticon_encoder_checkpoint():
    module = jax_ticon.TiconEncoder(**_TICON_REDUCED)
    params = _init_params(module, np.zeros((1, 1, 32), np.float32), np.zeros((1, 1, 2), np.float32))
    return _ticon_checkpoint(params)


# (JAX converter, port converter, port module, synthetic checkpoint)
_CONVERTERS = {
    "coca": (
        lambda sd: jax_coca.convert_coca_state_dict(sd, jax_coca.CoCaVisionConfig(**_COCA)),
        lambda sd: coca.convert_coca_state_dict(sd, coca.CoCaVisionConfig(**_COCA)),
        lambda: coca.CoCaVisionTower(coca.CoCaVisionConfig(**_COCA)),
        _coca_checkpoint,
    ),
    "beit3": (
        lambda sd: jax_beit3.convert_beit3_state_dict(sd, jax_beit3.Beit3Config(**_BEIT3)),
        lambda sd: beit3.convert_beit3_state_dict(sd, beit3.Beit3Config(**_BEIT3)),
        lambda: beit3.Beit3VisionTower(beit3.Beit3Config(**_BEIT3)),
        _beit3_checkpoint,
    ),
    "clip": (
        lambda sd: jax_clip.convert_clip_vision_state_dict(sd, jax_clip.CLIPVisionConfig(**_CLIP)),
        lambda sd: clip_vision.convert_clip_vision_state_dict(sd, clip_vision.CLIPVisionConfig(**_CLIP)),
        lambda: clip_vision.CLIPVisionTower(clip_vision.CLIPVisionConfig(**_CLIP)),
        _clip_checkpoint,
    ),
    "swin": (
        jax_swin.convert_ctranspath_state_dict,
        swin.convert_ctranspath_state_dict,
        lambda: swin.SwinTransformer(**_SWIN_REDUCED),
        _swin_checkpoint,
    ),
    "ticon": (
        lambda sd: jax_ticon.convert_ticon_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()}),
        lambda sd: ticon.convert_ticon_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()}),
        lambda: ticon.TiconEncoder(**_TICON_REDUCED),
        _ticon_encoder_checkpoint,
    ),
}


@pytest.mark.parametrize("name", sorted(_CONVERTERS))
def test_upstream_converter_matches_jax(name):
    """The port's converter gives exactly the JAX converter's tree under the
    port's names (torch tensors in, as a checkpoint loads), and it loads
    strictly into the port's tower."""
    jax_convert, port_convert, port_module, checkpoint = _CONVERTERS[name]
    sd = checkpoint()
    want = towers.state_dict_from_flax(jax_convert(sd))
    got = port_convert({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    port_module().load_state_dict(got)


def test_keep_split_matches_jax():
    from stamp_tpu.preprocessing.extractor.clip_like import keep_split_state_dict as jax_split
    from stamp_tpu_torch.preprocessing.extractor.clip_like import keep_split_state_dict

    rng = np.random.default_rng(0)
    sd = {"visual.blocks.0.ls1.weight": rng.normal(size=4), "visual.blocks.0.attn.qkv.weight": rng.normal(size=(6, 2)),
          "visual.cls_token": rng.normal(size=(1, 1, 2)), "text.ignored": rng.normal(size=3),
          **{f"visual_head.{i}.{k}": rng.normal(size=3) for i in (0, 2) for k in ("weight", "bias")}}  # fmt: skip
    trunk, head = keep_split_state_dict(sd)
    want_trunk, want_head = jax_split(sd)
    assert set(trunk) == set(want_trunk) == {"blocks.0.ls1.gamma", "blocks.0.attn.qkv.weight", "cls_token"}
    assert all(np.array_equal(trunk[k], want_trunk[k]) for k in trunk)
    assert set(head) == set(want_head) and all(np.array_equal(head[k], want_head[k]) for k in head)


# --- each family's extractor through both packages' factories --------------------

# LayerScale 1.0: at the zoo's 1e-5 a random block would hardly move the output
_TINY_VIT = dict(patch_size=32, embed_dim=32, depth=1, num_heads=2, init_values=1.0)


def _save(path, sd) -> None:
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if path.suffix == ".safetensors":
        from safetensors.torch import save_file

        save_file(tensors, str(path))
    else:
        torch.save(tensors, path)


def _timm_checkpoint(cfg) -> dict[str, np.ndarray]:
    model = torch_vit.init_random_weights_(torch_vit.ImageViT(cfg), torch.Generator().manual_seed(5))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _patch_factory(monkeypatch, module, name: str, **kwargs) -> None:
    """``module.name()`` builds the reduced config or tower from then on."""
    original = getattr(module, name)
    monkeypatch.setattr(module, name, functools.partial(original, **kwargs))


def _family(family: str, monkeypatch, weights) -> None:
    """Reduce ``family`` in both packages and write its checkpoint(s) into
    ``weights`` under the names its factories search for."""
    import stamp_tpu.preprocessing.extractor.clip_like as jax_clip_like
    import stamp_tpu.preprocessing.extractor.coca_beit3 as jax_coca_beit3
    import stamp_tpu.preprocessing.extractor.swin as jax_swin_ext
    import stamp_tpu.preprocessing.extractor.ticon as jax_ticon_ext

    if family == "conch":
        monkeypatch.setitem(jax_coca.COCA_CONFIGS, "conch", jax_coca.CoCaVisionConfig(**_COCA))
        monkeypatch.setitem(coca.COCA_CONFIGS, "conch", coca.CoCaVisionConfig(**_COCA))
        _save(weights / "conch.bin", _coca_checkpoint())
    elif family == "musk":
        _patch_factory(monkeypatch, jax_coca_beit3, "Beit3Config", **_BEIT3)
        _patch_factory(monkeypatch, beit3, "Beit3Config", **_BEIT3)
        _save(weights / "MUSK.pth", _beit3_checkpoint())
    elif family == "plip":
        _patch_factory(monkeypatch, jax_clip_like, "CLIPVisionConfig", **_CLIP)
        _patch_factory(monkeypatch, clip_vision, "CLIPVisionConfig", **_CLIP)
        _save(weights / "plip_pytorch_model.bin", _clip_checkpoint())
    elif family == "keep":
        monkeypatch.setitem(jax_vit.VIT_CONFIGS, "uni", jax_vit.ViTConfig(**_TINY_VIT))
        monkeypatch.setitem(torch_vit.VIT_CONFIGS, "uni", torch_vit.ViTConfig(**_TINY_VIT))
        trunk = _timm_checkpoint(torch_vit.ViTConfig(**_TINY_VIT))
        sd = {"visual." + k.replace(".gamma", ".weight"): v for k, v in trunk.items()}
        rng = np.random.default_rng(6)
        for i, shape in ((0, (768, 32)), (2, (768, 768))):
            sd[f"visual_head.{i}.weight"] = rng.normal(0, 0.05, shape).astype(np.float32)
            sd[f"visual_head.{i}.bias"] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
        _save(weights / "KEEP.safetensors", sd)
    elif family == "ticon":
        # the zoo's LayerScale 1e-5 here: the six encoder blocks of random
        # weights after it amplify the tile tower's bf16 rounding (at 1.0,
        # 3.4e-2 of max |ref| between the packages, 4.3e-6 in f32)
        tiny = dict(_TINY_VIT, init_values=1e-5, num_reg_tokens=4, ffn="swiglu", mlp_ratio=4.0,
                    mean=(0.7, 0.6, 0.7), std=(0.2, 0.2, 0.2))  # fmt: skip
        monkeypatch.setitem(jax_vit.VIT_CONFIGS, "h_optimus", jax_vit.ViTConfig(**tiny))
        monkeypatch.setitem(torch_vit.VIT_CONFIGS, "h_optimus", torch_vit.ViTConfig(**tiny))
        _patch_factory(monkeypatch, jax_ticon_ext, "TiconEncoder", **_TICON_REDUCED)
        _patch_factory(monkeypatch, ticon, "TiconEncoder", **_TICON_REDUCED)
        _save(weights / "h-optimus-1.safetensors", _timm_checkpoint(torch_vit.ViTConfig(**tiny)))
        _save(weights / "TICON_checkpoint.pth", _ticon_encoder_checkpoint())
    elif family == "ctranspath":
        _patch_factory(monkeypatch, jax_swin_ext, "SwinTransformer", **_SWIN_REDUCED)
        _patch_factory(monkeypatch, swin, "SwinTransformer", **_SWIN_REDUCED)
        _save(weights / "ctranspath.pth", _swin_checkpoint())


_FAMILIES = ("conch", "musk", "plip", "keep", "ticon", "ctranspath")


@pytest.mark.parametrize("precision", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", _FAMILIES)
def test_extractor_matches_jax(family, precision, tmp_path, monkeypatch):
    """One checkpoint, one batch of uint8 tiles (3, padded to 4) through
    both packages' extractors: bf16 (Swin f32) and W8A8, each calibrating on
    its first, padded batch.  No kernel launches on the CPU."""
    from stamp_tpu.preprocessing.extractor import set_int8_extraction as jax_set_int8
    from stamp_tpu.preprocessing.extractor.zoo import resolve_extractor as jax_resolve
    from stamp_tpu_torch.preprocessing.extractor import set_int8_extraction
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    weights = tmp_path / "weights"
    weights.mkdir()
    _family(family, monkeypatch, weights)
    monkeypatch.setenv("STAMP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("STAMP_RANDOM_WEIGHTS", raising=False)
    monkeypatch.setenv("STAMP_EXTRACT_BATCH", "4")
    launches = (torch_attn.LAUNCHES, torch_lnd.LAUNCHES, torch_lnd.QUANT_LAUNCHES)
    int8 = precision == "int8"
    jax_set_int8(int8)
    set_int8_extraction(int8)
    try:
        want_ext, got_ext = jax_resolve(family), resolve_extractor(family, CPU)
    finally:
        jax_set_int8(None)
        set_int8_extraction(None)
    assert (got_ext.identifier, got_ext.input_px, got_ext.feat_dim, got_ext.precision) == (
        want_ext.identifier, want_ext.input_px, want_ext.feat_dim, want_ext.precision)  # fmt: skip
    px = got_ext.input_px
    tiles = np.random.default_rng(7).integers(0, 256, (3, px, px, 3), dtype=np.uint8)
    for batch in (tiles, tiles[::-1].copy()):  # the first calibrates in int8
        want = np.asarray(want_ext.forward(batch), np.float32)
        got = got_ext.forward(batch).numpy()
        assert got.shape == want.shape == (3, want.shape[1])
        if family == "ctranspath" and not int8:  # f32 in both packages
            np.testing.assert_allclose(got, want, atol=1e-3)
        else:
            assert np.abs(got - want).max() <= EXTRACTOR_REL_TOL[precision] * np.abs(want).max()
            assert _cosine(got, want).min() >= BF16_COSINE_MIN
    assert (torch_attn.LAUNCHES, torch_lnd.LAUNCHES, torch_lnd.QUANT_LAUNCHES) == launches


# The extractors normalize uint8 tiles in f32 and run bf16 towers (Swin f32),
# and int8 calibrates each package's scales on its own bf16 activations, so a
# scale and the values at a tie of the int8 grid differ too.  Measured max
# |Δ| / max |ref|: bf16 ≤ 1.42e-2 (ticon; ctranspath in f32 3.4e-7), int8 ≤
# 2.49e-2 (musk); per-tile cosine ≥ 0.99956.  The limits are 3e-2 and 5e-2,
# and 0.999.
EXTRACTOR_REL_TOL = {"bfloat16": 3e-2, "int8": 5e-2}


# --- the slice as a whole: both CLIs on one slide --------------------------------


@pytest.fixture
def synthetic_slide(tmp_path):
    """1536×1024 TIFF at 1 µm/px: left 2/3 textured 'tissue', right white
    (16 tissue tiles of 256 µm)."""
    rng = np.random.default_rng(0)
    arr = np.full((1024, 1536, 3), 255, np.uint8)
    arr[:, :1024] = rng.integers(60, 200, (1024, 1024, 3), dtype=np.uint8)
    slides = tmp_path / "slides"
    slides.mkdir()
    Image.fromarray(arr).save(slides / "slide.tif", format="TIFF", compression="tiff_lzw",
                              resolution=10000.0, resolution_unit=3)  # fmt: skip
    return slides


def _read_sorted(path):
    import h5py

    with h5py.File(path) as h5:
        attrs, feats, coords = dict(h5.attrs), np.asarray(h5["feats"]), np.asarray(h5["coords"])
    order = np.lexsort((coords[:, 1], coords[:, 0]))
    return attrs, feats[order].astype(np.float32), coords[order]


@pytest.mark.parametrize("family", ["conch", "ctranspath"])
def test_cli_preprocess_matches_jax_package(family, synthetic_slide, tmp_path, monkeypatch):
    """``python -m stamp_tpu_torch -c config.yaml preprocess`` against
    ``python -m stamp_tpu -c config.yaml preprocess`` (both in-process) on
    one slide and one checkpoint: CONCH reduced to width 32, Swin to width
    16; the h5s compared sorted by coords at atol 5e-2, as
    ``tests/test_torch_extract.py`` compares the ImageViT's."""
    import logging

    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    weights = tmp_path / "weights"
    weights.mkdir()
    _family(family, monkeypatch, weights)
    monkeypatch.setenv("STAMP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("STAMP_RANDOM_WEIGHTS", raising=False)
    handlers = list(logging.getLogger("stamp").handlers)
    for package in ("jax", "torch"):
        section = {"output_dir": str(tmp_path / package), "wsi_dir": str(synthetic_slide), "extractor": family,
                   "device": "cpu", "max_workers": 2}  # fmt: skip
        config = tmp_path / f"{package}.yaml"
        config.write_text(yaml.safe_dump({"preprocessing": section}))
        if package == "jax":
            monkeypatch.setattr(sys, "argv", ["stamp", "-c", str(config), "preprocess"])
            jax_main()
        else:
            torch_main(["-c", str(config), "preprocess"])
    for handler in logging.getLogger("stamp").handlers[:]:
        if handler not in handlers:
            logging.getLogger("stamp").removeHandler(handler)
            handler.close()

    (jax_h5,), (torch_h5,) = (sorted((tmp_path / p).rglob("*.h5")) for p in ("jax", "torch"))
    assert jax_h5.parent.name.startswith(f"{family}-") and torch_h5.parent.name.startswith(f"{family}-")
    want_attrs, want, want_coords = _read_sorted(jax_h5)
    got_attrs, got, got_coords = _read_sorted(torch_h5)
    assert want_attrs.pop("code_hash") != got_attrs.pop("code_hash")
    assert got_attrs == want_attrs and got_attrs["extractor"] == family
    np.testing.assert_array_equal(got_coords, want_coords)
    assert got.shape == want.shape == (16, {"conch": 16, "ctranspath": 128}[family])
    np.testing.assert_allclose(got, want, atol=5e-2)

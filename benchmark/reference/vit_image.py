"""Plain PyTorch forward of an image ViT tile encoder (UNI2-h), in float32.

It follows timm's ViT as the configuration file states it (UNI2-h:
ViT-H/14 with 8 register tokens, SwiGLU feed-forward, LayerScale,
class-token pooling), with weights by timm's names.  Two of the file's keys
set the layout: ``no_embed_class`` (true: the position embedding covers the
patches alone; false: it has a first row, which the class token adds; the
register tokens never take one) and ``mlp_norm`` (the SwiGLU feed-forward
normalises its gated hidden state, ``mlp.norm``, before ``fc2``).

``quant="int4"`` is the control: every block linear (qkv, proj, fc1, fc2)
takes int4 weights (symmetric, per output channel) and int4 activations
(symmetric, per tensor, from the activation's own maximum), emulated in
float32.  Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import float32_exact


def _fake_quant(t: torch.Tensor, levels: int, dim: int | None) -> torch.Tensor:
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / levels
    return torch.clamp(torch.round(t / scale), -levels, levels) * scale


def _linear(x: torch.Tensor, state: dict, name: str, quant: str | None) -> torch.Tensor:
    w, b = state[f"{name}.weight"], state.get(f"{name}.bias")
    if quant == "int4":
        x, w = _fake_quant(x, 7, None), _fake_quant(w, 7, 1)
    return F.linear(x, w, b)


def _norm(x: torch.Tensor, state: dict, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], state[f"{name}.weight"], state[f"{name}.bias"], eps)


def features(state: dict[str, torch.Tensor], config: dict, images: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    """uint8 tiles [B, H, W, 3] → float32 features [B, embed_dim].

    ``state`` maps timm's names to float32 tensors on the images' device."""
    eps, dim, heads = config["norm_eps"], config["embed_dim"], config["num_heads"]
    mean = torch.tensor(config["mean"], device=images.device) * 255.0
    std = torch.tensor(config["std"], device=images.device) * 255.0
    with float32_exact():
        x = ((images.float() - mean) / std).permute(0, 3, 1, 2)
        b = x.shape[0]
        patches = F.conv2d(x, state["patch_embed.proj.weight"], state["patch_embed.proj.bias"],
                           stride=config["patch_size"]).flatten(2).transpose(1, 2)  # fmt: skip
        pos = state["pos_embed"]
        tokens = []
        if config["class_token"]:
            cls = state["cls_token"].expand(b, -1, -1)
            if not config["no_embed_class"]:
                cls, pos = cls + pos[:, :1], pos[:, 1:]
            tokens.append(cls)
        if config["num_reg_tokens"]:
            tokens.append(state["reg_token"].expand(b, -1, -1))
        x = torch.cat(tokens + [patches + pos], dim=1)
        n = x.shape[1]
        for i in range(config["depth"]):
            p = f"blocks.{i}."
            qkv = _linear(_norm(x, state, p + "norm1", eps), state, p + "attn.qkv", quant)
            q, k, v = qkv.reshape(b, n, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
            weights = torch.softmax(q @ k.transpose(-1, -2) * (dim // heads) ** -0.5, dim=-1)
            attn = (weights @ v).transpose(1, 2).reshape(b, n, dim)
            x = x + state[p + "ls1.gamma"] * _linear(attn, state, p + "attn.proj", quant)
            h = _linear(_norm(x, state, p + "norm2", eps), state, p + "mlp.fc1", quant)
            if config["ffn"] == "swiglu":
                h1, h2 = h.chunk(2, dim=-1)
                h = F.silu(h1) * h2
                if config["mlp_norm"]:
                    h = _norm(h, state, p + "mlp.norm", 1e-6)
            else:
                h = F.gelu(h) if config["act"] == "gelu" else F.silu(h)
            x = x + state[p + "ls2.gamma"] * _linear(h, state, p + "mlp.fc2", quant)
        x = _norm(x, state, "norm", eps)
        return x[:, 0]

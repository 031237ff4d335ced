"""The port's model parallelism for the extractor ViTs on the CPU
(``stamp_tpu_torch.parallel.tp_extractor`` and ``pp_extractor``), held to
the JAX package's ``make_tp_forward`` and ``make_pp_forward`` on the same
weights (flax init with random biases, γ and β → ``state_dict_from_jax``)
and the same numpy images.

One fleet of 2 gloo ranks (``_dist_dryrun``'s ``vit`` job) runs every case:

* TP over 2 ranks, ``ffn`` "mlp" and "swiglu", ``quant`` "off" and
  "int8", at ``tests/test_parallel.py:122-125``'s sizes, against JAX's
  TP forward on 2 of the conftest's 8 virtual devices, and against the
  port's whole model run in the same rank.  ``make_tp_forward`` of the JAX
  package cannot place an int8 tree (``_spec_for`` gives the 0-d ``amax``
  of qkv and fc1 ``P("tp")``), so the int8 reference shards the params
  with it and adds ``act_stats`` replicated;
* PP at P = 2 with 4 microbatches, and a ragged batch of 6, at
  ``tests/test_parallel.py:153-156``'s sizes, against JAX's PP forward on 2
  virtual devices.

``TOL``: both sides compute in f32 with other summation orders (the port's
row-sharded sums all-reduced, SwiGLU's statistics in two all-reduced
passes), 1e-4 of outputs of order 1, the JAX TP test's own tolerance; PP
moves whole blocks and is held to 1e-5, the JAX PP test's.  The int8 cases
quantize activations in two frameworks: a value a few ulps from a
half-integer can round to the neighbouring int8 step (``ROADMAP.md``,
Queue C test-design notes), which moves that image's output by 1e-2 of
max |ref| and more.  At these sizes that happens on most seeds, in the
port's whole model against JAX's and in JAX's TP against its own whole
model alike, so an int8 image is held to JAX's TP at ``TOL`` where no step
moved in either framework (the two whole models and JAX's TP agree within
``TOL``; at least half the images), and every image to the port's whole
model in the rank at ``TOL`` (one framework: the same steps), which
catches a fault of the sharding on any image.

In this process: each rank's share reassembles to the whole state dict
(heads of q, k and v; fc1's paired halves; the rows of proj and fc2), the
two new entry forms of ``ln_dense`` / ``ln_quant_dense`` (caller statistics,
partial sums) on two K slices against the one-rank result, and
``ImageViT``'s ``part`` split against the whole forward.
"""

import dataclasses
import json
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stamp_tpu.models import vit_image as jax_vit
from stamp_tpu.parallel.pp_extractor import make_pp_forward as jax_pp_forward
from stamp_tpu.parallel.tp_extractor import make_tp_forward as jax_tp_forward
from stamp_tpu.parallel.tp_extractor import shard_vit_params_tp as jax_shard_tp
from stamp_tpu_torch.models import vit_image
from stamp_tpu_torch.ops import ln_dense as lnd
from stamp_tpu_torch.parallel import pp_extractor, tp_extractor
from stamp_tpu_torch.parallel._dist_dryrun import VIT_AFFINE_STD, launch_local_fleet

TOL = 1e-4
PP_TOL = 1e-5
TP = 2

TP_CONFIG = dict(patch_size=32, embed_dim=128, depth=2, num_heads=8, mlp_ratio=4.0)
PP_CONFIG = dict(img_size=16, patch_size=8, embed_dim=32, depth=8, num_heads=4, num_reg_tokens=2)
TP_CASES = {f"{ffn}-{quant}": (ffn, quant) for ffn in ("mlp", "swiglu") for quant in ("off", "int8")}


def _images(cfg: jax_vit.ViTConfig, batch: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.normal(size=(batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


def _random_affine(tree, rng: np.random.Generator):
    """``tree`` with every ``bias`` (dense, conv, LayerNorm β) normal with
    std ``VIT_AFFINE_STD`` and every LayerNorm ``scale`` one plus such a
    draw, where flax's init leaves 0 and 1: a bias added once per rank, or
    one rank's γ slice on another, then shows in the output."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = _random_affine(value, rng)
        elif key in ("bias", "scale"):
            base = 1.0 if key == "scale" else 0.0
            out[key] = (base + VIT_AFFINE_STD * rng.normal(size=np.shape(value))).astype(np.float32)
        else:
            out[key] = value
    return out


def _jax_case(kwargs: dict, quant: str, images: np.ndarray) -> tuple[jax_vit.ViTConfig, dict]:
    """(config, variables) of a case: flax init at seed 0, its biases, γ
    and β then drawn at random (``_random_affine``); for int8 the params
    quantized and ``act_stats`` calibrated on ``images``."""
    cfg = jax_vit.ViTConfig(**kwargs)
    variables = jax_vit.ImageViT(cfg).init(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    variables = {"params": _random_affine(variables["params"], np.random.default_rng(1))}
    if quant == "int8":
        stats = jax_vit.calibrate_act_stats(cfg, variables, jnp.asarray(images))
        variables = {"params": jax_vit.quantize_vit_params(variables["params"], cfg), "act_stats": stats}
        cfg = dataclasses.replace(cfg, quant="int8")
    return cfg, jax.tree_util.tree_map(np.asarray, variables)


def _port_state(cfg: jax_vit.ViTConfig, variables: dict) -> dict[str, np.ndarray]:
    torch_cfg = vit_image.ViTConfig(**dataclasses.asdict(cfg))
    return {k: v.numpy() for k, v in vit_image.state_dict_from_jax(variables, torch_cfg).items()}


def _jax_tp(cfg, variables, images) -> np.ndarray:
    module = jax_vit.ImageViT(cfg)
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))
    forward, sharded = jax_tp_forward(module, {"params": variables["params"]}, mesh)
    if "act_stats" in variables:
        sharded = {**sharded, "act_stats": variables["act_stats"]}
    return np.asarray(forward(sharded, jnp.asarray(images)))


def _jax_whole(cfg, variables, images) -> np.ndarray:
    return np.asarray(jax_vit.ImageViT(cfg).apply(variables, jnp.asarray(images)))


def _jax_pp(cfg, variables, images) -> dict[str, np.ndarray]:
    mesh = Mesh(np.array(jax.devices()[:TP]), ("pp",))
    forward, (slab, rest) = jax_pp_forward(jax_vit.ImageViT(cfg), variables, mesh, n_microbatches=4)
    return {"full": np.asarray(forward(slab, rest, jnp.asarray(images))),
            "ragged": np.asarray(forward(slab, rest, jnp.asarray(images[:6])))}  # fmt: skip


def _write_job(root, name: str, parallel: str, cfg, variables, images: dict, **extra) -> dict:
    job_dir = root / name
    job_dir.mkdir()
    np.savez(job_dir / "state.npz", **_port_state(cfg, variables))
    np.savez(job_dir / "inputs.npz", **images)
    config = dataclasses.asdict(cfg)
    spec = dict(parallel=parallel, config=config, batches=sorted(images), against_single=True, **extra)
    return dict(kind="vit", spec=spec, dir=str(job_dir))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Every case in one 2-rank fleet, and meanwhile the JAX references in
    this process: {case: (the port's rank-0 outputs, JAX's outputs)}, and
    each rank's report."""
    root = tmp_path_factory.mktemp("model_parallel")
    jobs, refs = [], {}
    for name, (ffn, quant) in TP_CASES.items():
        kwargs = dict(TP_CONFIG, ffn=ffn)
        images = _images(jax_vit.ViTConfig(**kwargs), 4)
        cfg, variables = _jax_case(kwargs, quant, images)
        jobs.append(_write_job(root, f"tp-{name}", "tp", cfg, variables, {"full": images}))
        refs[f"tp-{name}"] = (cfg, variables, images)
    images = _images(jax_vit.ViTConfig(**PP_CONFIG), 8)
    cfg, variables = _jax_case(PP_CONFIG, "off", images)
    jobs.append(_write_job(root, "pp", "pp", cfg, variables, {"full": images, "ragged": images[:6]},
                           n_microbatches=4))  # fmt: skip
    (root / "jobs.json").write_text(json.dumps(jobs))
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(launch_local_fleet, ["jobs", str(root / "jobs.json")], timeout=600,
                          env_extra={"OMP_NUM_THREADS": "1"})  # fmt: skip
        want = {name: {"full": _jax_tp(*ref), "whole": _jax_whole(*ref)} for name, ref in refs.items()}
        want["pp"] = _jax_pp(cfg, variables, images)
        log = run.result()
    reports = [json.loads(line.split(" ", 2)[2]) for line in log.splitlines() if line.startswith("VIT ")]
    got = {job["dir"].rsplit("/", 1)[-1]: dict(np.load(f"{job['dir']}/result.npz")) for job in jobs}
    return got, want, reports


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_tp_matches_jax(fleet, case):
    got, want, _ = fleet
    out, ref = got[f"tp-{case}"]["full"], want[f"tp-{case}"]["full"]
    assert out.shape == ref.shape == (4, TP_CONFIG["embed_dim"])
    if case.endswith("int8"):  # the images where no int8 step moved in either framework
        whole, single = want[f"tp-{case}"]["whole"], got[f"tp-{case}"]["single/full"]
        steady = (np.abs(single - whole).max(-1) <= TOL) & (np.abs(ref - whole).max(-1) <= TOL)
        assert 2 * steady.sum() >= len(steady), steady
        out, ref = out[steady], ref[steady]
    np.testing.assert_allclose(out, ref, atol=TOL)


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_tp_matches_the_whole_model(fleet, case):
    got, _, _ = fleet
    np.testing.assert_allclose(got[f"tp-{case}"]["full"], got[f"tp-{case}"]["single/full"], atol=TOL)


@pytest.mark.parametrize("batch", ["full", "ragged"])
def test_pp_matches_jax(fleet, batch):
    got, want, _ = fleet
    out, ref = got["pp"][batch], want["pp"][batch]
    assert out.shape == ref.shape == ({"full": 8, "ragged": 6}[batch], PP_CONFIG["embed_dim"])
    np.testing.assert_allclose(out, ref, atol=PP_TOL)
    # the same blocks in the same order on the same rows: bitwise the whole model in the rank
    np.testing.assert_array_equal(out, got["pp"][f"single/{batch}"])


def test_every_rank_returns_the_whole_output(fleet):
    _, _, reports = fleet
    assert len(reports) == 2 * (len(TP_CASES) + 1)
    for report in reports:
        for batch, row in report["batches"].items():
            assert row["rank_spread"] == 0.0, (report["job"], batch)


def _state(kwargs: dict) -> tuple[vit_image.ViTConfig, dict[str, torch.Tensor]]:
    cfg = vit_image.ViTConfig(**kwargs)
    model = vit_image.ImageViT(cfg)
    vit_image.init_random_weights_(model, torch.Generator().manual_seed(0), affine_std=VIT_AFFINE_STD)
    return cfg, model.state_dict()


@pytest.mark.parametrize("tp", [2, 4])
def test_qkv_shards_are_whole_heads(tp):
    cfg, sd = _state(dict(TP_CONFIG, ffn="swiglu"))
    dim, d = cfg.embed_dim, cfg.embed_dim // cfg.num_heads
    shares = [tp_extractor.shard_vit_params_tp(sd, cfg, r, tp) for r in range(tp)]
    whole = sd["blocks.0.attn.qkv.weight"].view(3, cfg.num_heads, d, dim)
    for r, share in enumerate(shares):
        local = share["blocks.0.attn.qkv.weight"].view(3, cfg.num_heads // tp, d, dim)
        heads = slice(r * cfg.num_heads // tp, (r + 1) * cfg.num_heads // tp)
        assert torch.equal(local, whole[:, heads])  # q, k and v of the same heads
        assert torch.equal(share["blocks.0.attn.qkv.bias"].view(3, -1), sd["blocks.0.attn.qkv.bias"].view(3, tp, -1)[:, r])
    # the shares of q, k and v reassemble to the packed weight
    parts = [s["blocks.0.attn.qkv.weight"].view(3, dim // tp, dim) for s in shares]
    assert torch.equal(torch.cat(parts, dim=1).reshape(3 * dim, dim), sd["blocks.0.attn.qkv.weight"])


@pytest.mark.parametrize("tp", [2, 4])
def test_swiglu_fc1_shards_pair_their_halves(tp):
    cfg, sd = _state(dict(TP_CONFIG, ffn="swiglu"))
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    x1, x2 = sd["blocks.1.mlp.fc1.weight"].chunk(2)
    shares = [tp_extractor.shard_vit_params_tp(sd, cfg, r, tp) for r in range(tp)]
    for r, share in enumerate(shares):
        local = share["blocks.1.mlp.fc1.weight"]
        assert local.shape == (hidden // tp, cfg.embed_dim)
        l1, l2 = local.chunk(2)  # the rank's x1 ‖ x2 chunks are the same rows of each half
        rows = slice(r * hidden // (2 * tp), (r + 1) * hidden // (2 * tp))
        assert torch.equal(l1, x1[rows]) and torch.equal(l2, x2[rows])
        # the inner LayerNorm's γ, β: fc2's K slice, the same rows
        for leaf in ("weight", "bias"):
            assert torch.equal(share[f"blocks.1.mlp.norm.{leaf}"], sd[f"blocks.1.mlp.norm.{leaf}"][rows])
    halves = [torch.cat([s["blocks.1.mlp.fc1.weight"].chunk(2)[h] for s in shares]) for h in range(2)]
    assert torch.equal(torch.cat(halves), sd["blocks.1.mlp.fc1.weight"])


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_row_sharded_sites_reassemble_and_replicate_the_rest(ffn):
    cfg, sd = _state(dict(TP_CONFIG, ffn=ffn))
    shares = [tp_extractor.shard_vit_params_tp(sd, cfg, r, TP) for r in range(TP)]
    for site in ("attn.proj", "mlp.fc2"):
        key = f"blocks.0.{site}.weight"
        assert torch.equal(torch.cat([s[key] for s in shares], dim=1), sd[key])
        for s in shares:  # the bias of a row-sharded site is added once, after the all-reduce
            assert torch.equal(s[f"blocks.0.{site}.bias"], sd[f"blocks.0.{site}.bias"])
    if ffn == "mlp":  # a plain fc1: contiguous rows
        assert torch.equal(torch.cat([s["blocks.0.mlp.fc1.weight"] for s in shares]), sd["blocks.0.mlp.fc1.weight"])
    for key in ("pos_embed", "cls_token", "patch_embed.proj.weight", "blocks.0.norm1.weight", "norm.bias"):
        assert all(torch.equal(s[key], sd[key]) for s in shares), key


def test_int8_shares_replicate_amax_and_row_scales():
    """As ``_spec_for``: 0-d and the row-sharded sites' 1-D leaves are
    replicated, the column-sharded sites' ``w_scale`` cut with their rows."""
    cfg, sd = _state(dict(TP_CONFIG, ffn="swiglu"))
    cfg = dataclasses.replace(cfg, quant="int8")
    sd = vit_image.quantize_vit_params(sd, cfg)
    sd |= {f"{site}.amax": torch.tensor(float(i + 1)) for i, site in enumerate(vit_image.vit_quant_sites(cfg.depth))}
    share = tp_extractor.shard_vit_params_tp(sd, cfg, 1, TP)
    for site in vit_image.vit_quant_sites(cfg.depth):
        assert torch.equal(share[f"{site}.amax"], sd[f"{site}.amax"])
    assert torch.equal(share["blocks.0.attn.proj.w_scale"], sd["blocks.0.attn.proj.w_scale"])
    assert torch.equal(share["blocks.0.attn.qkv.w_scale"].view(3, -1), sd["blocks.0.attn.qkv.w_scale"].view(3, TP, -1)[:, 1])
    assert share["blocks.0.mlp.fc2.weight_q"].shape == (cfg.embed_dim, sd["blocks.0.mlp.fc2.weight_q"].shape[1] // TP)


def test_jax_and_port_shard_the_same_column_layout():
    """The port's fc1 share of an MLP ViT is the JAX package's column share
    (``P(None, "tp")``) transposed."""
    kwargs = dict(TP_CONFIG, ffn="mlp")
    cfg, variables = _jax_case(kwargs, "off", _images(jax_vit.ViTConfig(**kwargs), 1))
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))
    leaf = jax_shard_tp(variables, mesh)["params"]["block_0"]["mlp"]["fc1"]["kernel"]
    jax_shares = [np.asarray(s.data) for s in sorted(leaf.addressable_shards, key=lambda s: s.index[1].start)]
    sd = {k: torch.from_numpy(v) for k, v in _port_state(cfg, variables).items()}
    for r, jax_share in enumerate(jax_shares):
        port = tp_extractor.shard_vit_params_tp(sd, vit_image.ViTConfig(**kwargs), r, TP)
        np.testing.assert_array_equal(port["blocks.0.mlp.fc1.weight"].numpy().T, jax_share)


def test_tp_refuses_calibration_and_uneven_heads():
    cfg, sd = _state(dict(TP_CONFIG, ffn="swiglu"))
    with torch.device("meta"):
        observe = vit_image.ImageViT(dataclasses.replace(cfg, quant="observe"))
    with pytest.raises(ValueError, match="calibrate on one rank"):
        tp_extractor.make_tp_forward(observe, sd, device="cpu")
    with pytest.raises(ValueError, match="heads do not split"):
        tp_extractor.shard_vit_params_tp(sd, cfg, 0, 3)


def test_pp_stage_blocks_and_indivisible_depth():
    cfg, sd = _state(PP_CONFIG)
    blocks, rest = pp_extractor.stack_block_params(sd, cfg.depth, 2, 1)
    assert set(blocks) == {k.replace(f"blocks.{i + 4}.", f"blocks.{i}.") for k in sd for i in range(4)
                           if k.startswith(f"blocks.{i + 4}.")}  # fmt: skip
    assert torch.equal(blocks["blocks.0.attn.qkv.weight"], sd["blocks.4.attn.qkv.weight"])
    assert set(rest) == {k for k in sd if not k.startswith("blocks.")}
    with pytest.raises(ValueError, match="depth 8 not divisible by 3 stages"):
        pp_extractor.stack_block_params(sd, cfg.depth, 3)


def test_image_vit_parts_compose_to_the_forward():
    cfg, sd = _state(dict(PP_CONFIG, pool="token_avg_concat"))
    model = vit_image.ImageViT(cfg).eval()
    model.load_state_dict(sd)
    images = torch.from_numpy(_images(cfg, 3))
    with torch.inference_mode():
        tokens = model(images, part="embed")
        assert tokens.shape == (3, cfg.num_prefix_tokens + cfg.num_patches, cfg.embed_dim)
        x = tokens
        for block in model.blocks:
            x = block(x)
        assert torch.equal(model(x, part="head"), model(images))
    with pytest.raises(ValueError, match="part"):
        model(images, part="blocks")


# --- the two new entry forms of ln_dense / ln_quant_dense, plain versions ----

M, K, N = 37, 64, 24  # K splits into two slices of 32


def _ln_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32) * 2 + 0.5)
    g = torch.from_numpy(1 + 0.1 * rng.normal(size=K).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.normal(size=K).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * K**-0.5)
    bias = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    return x, g, b, w, bias


def _slice_stats(x: torch.Tensor) -> torch.Tensor:
    """``row_stats`` of two K slices with their sums all-reduced (summed)."""
    halves = x.chunk(2, dim=1)
    sums = [h.float().sum(-1) for h in halves]

    def total(t, parts):
        t.copy_(sum(parts))

    means = sum(sums) / K
    sq = [((h.float() - means[:, None]) ** 2).sum(-1) for h in halves]
    calls = iter([sums, sq])
    return lnd.row_stats(halves[0], 1e-6, k=K, reduce=lambda t: total(t, next(calls)))


def test_row_stats_of_slices_are_the_layer_norms():
    x = _ln_inputs()[0]
    stats = _slice_stats(x)
    mean = x.mean(-1)
    rstd = torch.rsqrt(((x - mean[:, None]) ** 2).mean(-1) + 1e-6)
    torch.testing.assert_close(stats, torch.stack([mean, rstd]), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lnd.row_stats(x, 1e-6), torch.stack([mean, rstd]), rtol=1e-6, atol=1e-6)


def test_ln_dense_partial_slices_sum_to_one_rank():
    """Two K slices, each normalized with the all-reduced statistics, their
    partial sums added and the bias added once: the one-rank result within
    f32 rounding of the sum order (1e-5 of outputs of order 1)."""
    x, g, b, w, bias = _ln_inputs()
    stats = _slice_stats(x)
    parts = [lnd.ln_dense(xs, gs, bs, ws, stats=stats, partial=True)
             for xs, gs, bs, ws in zip(x.chunk(2, 1), g.chunk(2), b.chunk(2), w.chunk(2, 1))]  # fmt: skip
    assert all(p.dtype == torch.float32 for p in parts)
    got = (parts[0] + parts[1] + bias).to(x.dtype)
    torch.testing.assert_close(got, lnd.ln_dense(x, g, b, w, bias), rtol=0, atol=1e-5)
    # with the caller's statistics alone, the bf16 epilogue: the one-rank result
    torch.testing.assert_close(lnd.ln_dense(x, g, b, w, bias, stats=lnd.row_stats(x, 1e-6)),
                               lnd.ln_dense(x, g, b, w, bias), rtol=0, atol=1e-5)  # fmt: skip
    with pytest.raises(ValueError, match="no dense bias"):
        lnd.ln_dense(x, g, b, w, bias, partial=True)


def test_ln_quant_dense_partial_slices_sum_exactly():
    """int8: the two slices' i32 sums add to the one-rank sums exactly
    (the statistics given alike), and the dequantized result matches."""
    x, g, b, w, bias = _ln_inputs(1)
    s_x = torch.tensor(4.0)
    scale = torch.clamp_min(w.abs().amax(dim=1), 1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    stats = lnd.row_stats(x, 1e-6)
    whole = lnd.ln_quant_dense(x, g, b, s_x, w_q, scale, stats=stats, partial=True)
    parts = [lnd.ln_quant_dense(xs, gs, bs, s_x, ws, scale, stats=stats, partial=True)
             for xs, gs, bs, ws in zip(x.chunk(2, 1), g.chunk(2), b.chunk(2), w_q.chunk(2, 1))]  # fmt: skip
    assert whole.dtype == torch.int32
    assert torch.equal(parts[0] + parts[1], whole)
    got = ((parts[0] + parts[1]).float() * (s_x / 127.0) * scale + bias).to(x.dtype)
    torch.testing.assert_close(got, lnd.ln_quant_dense(x, g, b, s_x, w_q, scale, bias, stats=stats), rtol=0, atol=0)
    # the kernel's own statistics and the slices' all-reduced ones: within f32 rounding
    torch.testing.assert_close(_slice_stats(x), stats, rtol=1e-6, atol=1e-6)

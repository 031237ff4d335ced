"""The port's MCP server (``stamp_tpu_torch.mcp.server``) on the CPU: the 8
tests of ``tests/test_mcp.py`` against the port's server (tool
registration, JSON-RPC dispatch, and a real preprocess + train drive
through ``_run_stamp`` with ``device: cpu`` and ``STAMP_ACCELERATOR=cpu``),
and its ``tools/list`` reply against the JAX package's server, schema for
schema.

Runs on the in-repo minimal MCP runtime when ``fastmcp`` is absent, as on
both machines.
"""

import asyncio
import json
import random

import numpy as np
import pytest
from PIL import Image

from random_data import create_random_dataset

EXPECTED_TOOLS = {
    "preprocess_stamp",
    "train_stamp",
    "crossval_stamp",
    "deploy_stamp",
    "statistics_stamp",
    "heatmaps_stamp",
    "encode_slides_stamp",
    "encode_patients_stamp",
    "read_file",
    "list_files",
    "analyze_csv",
    "list_column_values",
    "check_available_devices",
}


@pytest.fixture(scope="module")
def server():
    from stamp_tpu_torch.mcp import server

    return server


def test_all_tools_registered(server):
    assert set(server.mcp.tools) == EXPECTED_TOOLS


def test_tool_schemas_hide_context(server):
    for tool in server.mcp.tools.values():
        assert "ctx" not in tool.input_schema["properties"]
        assert tool.description  # every tool documents itself


def test_tool_schemas_type_optional_params(server):
    """PEP 604 unions (e.g. ``cache_dir: str | None``) must surface as the
    typed non-None schema, not an empty one."""
    schema = server.mcp.tools["preprocess_stamp"].input_schema["properties"]
    assert schema["cache_dir"] == {"type": "string"}
    assert schema["brightness_cutoff"] == {"type": "integer"}
    assert schema["default_slide_mpp"] == {"type": "number"}


def test_jsonrpc_initialize_and_list(server):
    sent: list[dict] = []
    response = server.mcp.handle_request({"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}}, sent.append)
    assert response["result"]["serverInfo"]["name"] == "stamp-tpu"

    response = server.mcp.handle_request({"jsonrpc": "2.0", "id": 2, "method": "tools/list"}, sent.append)
    listed = {t["name"] for t in response["result"]["tools"]}
    assert listed == EXPECTED_TOOLS


def test_jsonrpc_tool_call_roundtrip(server, tmp_path, monkeypatch):
    monkeypatch.setenv("STAMP_MCP_ROOT", str(tmp_path))
    monkeypatch.setattr(server, "STAMP_ROOT", tmp_path)
    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,x\n2,y\n")

    sent: list[dict] = []
    response = server.mcp.handle_request(
        {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
         "params": {"name": "analyze_csv", "arguments": {"path": "t.csv"}}},
        sent.append,
    )  # fmt: skip
    text = response["result"]["content"][0]["text"]
    assert "a" in text and "b" in text
    assert not response["result"]["isError"]


def test_jsonrpc_unknown_tool_is_an_error(server):
    response = server.mcp.handle_request(
        {"jsonrpc": "2.0", "id": 4, "method": "tools/call", "params": {"name": "nope", "arguments": {}}},
        lambda _m: None,
    )
    assert "error" in response


def test_preprocess_and_train_through_run_stamp(server, tmp_path, monkeypatch):
    """Two tools round-trip end to end through the temp-YAML → ``_run_cli``
    path: preprocess a synthetic WSI (``device: cpu``), then train on a
    synthetic cohort (``STAMP_ACCELERATOR=cpu``: the tool has no device
    parameter, and the default ``auto`` is the card)."""
    monkeypatch.setenv("STAMP_ACCELERATOR", "cpu")

    # --- preprocess a tiny synthetic slide with the `empty` extractor ----
    wsi_dir = tmp_path / "wsi"
    wsi_dir.mkdir()
    rng = np.random.default_rng(0)
    img = np.full((896, 896, 3), 255, np.uint8)
    img[224:672, 224:672] = rng.integers(50, 200, (448, 448, 3), np.uint8)
    Image.fromarray(img).save(wsi_dir / "s1.tiff", compression="tiff_lzw", resolution=10000.0, resolution_unit=3)

    result = asyncio.run(
        server.mcp.call_tool(
            "preprocess_stamp",
            {"output_dir": str(tmp_path / "pp"), "wsi_dir": str(wsi_dir), "extractor": "empty", "device": "cpu",
             "max_workers": 2},
        )
    )  # fmt: skip
    assert "completed successfully" in result, result
    assert list((tmp_path / "pp").rglob("*.h5"))

    # --- train on a synthetic feature cohort (labels seeded) -------------
    random.seed(0)
    cohort_dir = tmp_path / "cohort"
    cohort_dir.mkdir()
    clini, slide, feats, categories = create_random_dataset(
        dir=cohort_dir, n_patients=8, max_slides_per_patient=1, min_tiles_per_slide=8, max_tiles_per_slide=16,
        feat_dim=4, n_categories=2,
    )  # fmt: skip
    result = asyncio.run(
        server.mcp.call_tool(
            "train_stamp",
            {"output_dir": str(tmp_path / "train"), "clini_table": str(clini), "slide_table": str(slide),
             "feature_dir": str(feats), "ground_truth_label": "ground-truth", "patient_label": "patient",
             "filename_label": "slide_path", "categories": list(categories)},
        )
    )  # fmt: skip
    assert "completed successfully" in result, result
    assert (tmp_path / "train" / "model.ckpt").exists()


def test_stdio_protocol_line_format(server):
    """A serialized request through the dispatcher produces valid JSON-RPC."""
    sent: list[dict] = []
    request = json.loads('{"jsonrpc": "2.0", "id": 9, "method": "tools/list"}')
    response = server.mcp.handle_request(request, sent.append)
    serialized = json.dumps(response)
    assert json.loads(serialized)["id"] == 9


def test_tools_list_matches_the_jax_server(server):
    """The same tools, in the same order, with the same input schemas and
    descriptions; ``check_available_devices`` alone describes itself
    otherwise (it reports CUDA devices, the JAX server JAX's)."""
    from stamp_tpu.mcp import server as jax_server

    def listed(module) -> list[dict]:
        return module.mcp.handle_request({"jsonrpc": "2.0", "id": 1, "method": "tools/list"}, lambda _m: None)[
            "result"
        ]["tools"]

    port, jax = listed(server), listed(jax_server)
    assert [t["name"] for t in port] == [t["name"] for t in jax]
    for mine, theirs in zip(port, jax):
        assert mine["inputSchema"] == theirs["inputSchema"], mine["name"]
        if mine["name"] != "check_available_devices":
            assert mine["description"] == theirs["description"], mine["name"]
    assert "CUDA" in server.mcp.tools["check_available_devices"].description


def test_check_available_devices_reports_the_cpu(server, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert asyncio.run(server.mcp.call_tool("check_available_devices")) == "backend=cpu count=0 devices=['cpu']"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    reply = asyncio.run(server.mcp.call_tool("check_available_devices"))
    assert reply == "backend=cuda count=2 devices=['card 0', 'card 1']"


def test_server_speaks_json_rpc_over_stdio(tmp_path):
    """``python -m stamp_tpu_torch.mcp.server`` as a subprocess: one JSON
    reply per request line, in order, and none for a notification."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    requests = [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "method": "notifications/initialized"},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
        {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {"name": "check_available_devices"}},
    ]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": str(repo), "HOME": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "stamp_tpu_torch.mcp.server"], input="".join(json.dumps(r) + "\n" for r in requests),
        capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env,
    )  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-2000:]
    replies = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["id"] for r in replies] == [1, 2, 3]
    assert {t["name"] for t in replies[1]["result"]["tools"]} == EXPECTED_TOOLS
    assert replies[2]["result"]["content"][0]["text"].startswith("backend=")

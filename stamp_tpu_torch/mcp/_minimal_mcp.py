"""Minimal MCP server runtime (FastMCP-compatible subset).

The port's own copy of ``stamp_tpu/mcp/_minimal_mcp.py`` (framework-free;
the port imports nothing of the JAX package).  The reference serves its
tools through the third-party ``fastmcp`` package (reference
mcp/server.py:34).  This module is the in-repo fallback when fastmcp is not
installed: a small, dependency-free implementation of the Model Context
Protocol's tools surface speaking JSON-RPC 2.0 over newline-delimited stdio
— ``initialize``, ``tools/list``, ``tools/call`` and
``notifications/message`` log streaming.  ``server.py`` only uses
``FastMCP(name)``, the bare ``@mcp.tool`` decorator, ``mcp.run()`` and an
async ``Context.info``; all of that is provided here with the same
semantics, so the same server module runs under either runtime.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import sys
import types
import typing
from dataclasses import dataclass, field
from typing import Any, Callable

_PROTOCOL_VERSION = "2024-11-05"

_JSON_TYPES = {
    str: "string",
    int: "integer",
    float: "number",
    bool: "boolean",
    list: "array",
    dict: "object",
}


def _annotation_schema(annotation: Any) -> dict:
    """Best-effort JSON schema for a parameter annotation."""
    origin = typing.get_origin(annotation)
    if origin is typing.Union or origin is types.UnionType:
        non_none = [
            a for a in typing.get_args(annotation) if a is not type(None)
        ]
        if len(non_none) == 1:
            return _annotation_schema(non_none[0])
        return {"anyOf": [_annotation_schema(a) for a in non_none]}
    if origin in (list, tuple):
        return {"type": "array"}
    if annotation in _JSON_TYPES:
        return {"type": _JSON_TYPES[annotation]}
    return {}


class Context:
    """Call context handed to every tool; ``info`` streams a log line back
    to the client as a ``notifications/message``."""

    def __init__(self, send: Callable[[dict], None] | None = None):
        self._send = send
        self.messages: list[str] = []  # retained for tests / no-transport use

    async def info(self, message: str) -> None:
        self.messages.append(message)
        if self._send is not None:
            self._send({
                "jsonrpc": "2.0",
                "method": "notifications/message",
                "params": {"level": "info", "data": message},
            })


@dataclass
class _Tool:
    name: str
    fn: Callable
    description: str
    input_schema: dict
    ctx_param: str | None


@dataclass
class FastMCP:
    name: str
    _tools: dict[str, _Tool] = field(default_factory=dict)

    # -- registration --------------------------------------------------------

    def tool(self, fn: Callable) -> Callable:
        """Bare decorator: registers the coroutine as an MCP tool, deriving
        the input schema from its signature (the Context param is injected
        by the server, not exposed to clients)."""
        signature = inspect.signature(fn)
        hints = typing.get_type_hints(fn)
        properties: dict[str, dict] = {}
        required: list[str] = []
        ctx_param = None
        for param in signature.parameters.values():
            annotation = hints.get(param.name, param.annotation)
            if annotation is Context or param.name == "ctx":
                ctx_param = param.name
                continue
            properties[param.name] = _annotation_schema(annotation)
            if param.default is inspect.Parameter.empty:
                required.append(param.name)
        self._tools[fn.__name__] = _Tool(
            name=fn.__name__,
            fn=fn,
            description=inspect.getdoc(fn) or "",
            input_schema={
                "type": "object",
                "properties": properties,
                "required": required,
            },
            ctx_param=ctx_param,
        )
        return fn

    @property
    def tools(self) -> dict[str, _Tool]:
        return dict(self._tools)

    # -- direct invocation (tests, in-process agents) ------------------------

    async def call_tool(
        self, name: str, arguments: dict | None = None, ctx: Context | None = None
    ) -> str:
        tool = self._tools[name]
        kwargs = dict(arguments or {})
        if tool.ctx_param is not None:
            kwargs[tool.ctx_param] = ctx if ctx is not None else Context()
        return await tool.fn(**kwargs)

    # -- JSON-RPC dispatch ---------------------------------------------------

    def handle_request(
        self, request: dict, send: Callable[[dict], None]
    ) -> dict | None:
        """Handle one JSON-RPC request; returns the response object (None
        for notifications)."""
        rid = request.get("id")
        method = request.get("method")

        def respond(result: Any = None, *, error: dict | None = None):
            if rid is None:
                return None  # notification — no response
            message: dict = {"jsonrpc": "2.0", "id": rid}
            if error is not None:
                message["error"] = error
            else:
                message["result"] = result
            return message

        if method == "initialize":
            return respond({
                "protocolVersion": _PROTOCOL_VERSION,
                "capabilities": {"tools": {}},
                "serverInfo": {"name": self.name, "version": "1.0"},
            })
        if method == "notifications/initialized":
            return None
        if method == "tools/list":
            return respond({
                "tools": [
                    {
                        "name": t.name,
                        "description": t.description,
                        "inputSchema": t.input_schema,
                    }
                    for t in self._tools.values()
                ]
            })
        if method == "tools/call":
            params = request.get("params", {})
            name = params.get("name")
            if name not in self._tools:
                return respond(
                    error={"code": -32602, "message": f"unknown tool: {name}"}
                )
            try:
                result = asyncio.run(
                    self.call_tool(
                        name, params.get("arguments", {}), ctx=Context(send)
                    )
                )
            except Exception as e:  # tool bugs become protocol errors
                return respond(
                    error={"code": -32000, "message": f"{type(e).__name__}: {e}"}
                )
            return respond({
                "content": [{"type": "text", "text": str(result)}],
                "isError": False,
            })
        return respond(
            error={"code": -32601, "message": f"unknown method: {method}"}
        )

    # -- stdio transport -----------------------------------------------------

    def run(self) -> None:  # pragma: no cover — exercised via handle_request
        """Serve newline-delimited JSON-RPC on stdin/stdout until EOF."""

        def send(message: dict) -> None:
            sys.stdout.write(json.dumps(message) + "\n")
            sys.stdout.flush()

        for line in sys.stdin:
            if not line.strip():
                continue
            try:
                request = json.loads(line)
            except json.JSONDecodeError:
                send({
                    "jsonrpc": "2.0",
                    "id": None,
                    "error": {"code": -32700, "message": "parse error"},
                })
                continue
            response = self.handle_request(request, send)
            if response is not None:
                send(response)

"""MCP server — expose document-store/RAG endpoints as MCP tools
(reference: python/pathway/xpacks/llm/mcp_server.py McpServer:143,
McpServable:129, PathwayMcp:237; fastmcp there, a self-contained
JSON-RPC-over-HTTP implementation here)."""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Type

from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector


class McpServable:
    """Implement `register_mcp(server)` to expose tools (reference:
    mcp_server.py McpServable:129)."""

    def register_mcp(self, server: "McpServer") -> None:
        raise NotImplementedError


class McpConfig:
    def __init__(self, name: str = "pathway-mcp", transport: str = "streamable-http", host: str = "127.0.0.1", port: int = 8123):
        self.name = name
        self.transport = transport
        self.host = host
        self.port = port


class McpServer:
    """Streamable-HTTP MCP endpoint: JSON-RPC methods initialize,
    tools/list, tools/call (reference: mcp_server.py McpServer:143)."""

    _instances: Dict[str, "McpServer"] = {}

    def __init__(self, config: McpConfig):
        self.config = config
        self.webserver = PathwayWebserver(config.host, config.port)
        self._tools: Dict[str, dict] = {}

    @classmethod
    def get(cls, config: McpConfig) -> "McpServer":
        key = f"{config.host}:{config.port}"
        if key not in cls._instances:
            cls._instances[key] = cls(config)
        return cls._instances[key]

    def tool(
        self,
        name: str,
        *,
        request_handler: Callable,
        schema: Type[Schema],
        description: str | None = None,
    ) -> None:
        """Register a tool backed by a dataflow handler (handler(table) ->
        result table with `result` column)."""
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=f"/mcp/tools/{name}",
            schema=schema,
            methods=("POST",),
            delete_completed_queries=True,
        )
        writer(request_handler(queries))
        self._tools[name] = {
            "name": name,
            "description": description or name,
            "inputSchema": {
                "type": "object",
                "properties": {
                    col: {"type": _json_type(c.dtype)}
                    for col, c in schema.columns().items()
                },
            },
        }
        self._register_rpc_route()

    _rpc_registered = False

    def _register_rpc_route(self) -> None:
        if self._rpc_registered:
            return
        self._rpc_registered = True

        async def rpc_handler(payload: dict, request):
            method = payload.get("method")
            msg_id = payload.get("id")
            if method == "initialize":
                result = {
                    "protocolVersion": "2024-11-05",
                    "serverInfo": {"name": self.config.name, "version": "1.0"},
                    "capabilities": {"tools": {}},
                }
            elif method == "tools/list":
                result = {"tools": list(self._tools.values())}
            elif method == "tools/call":
                params = payload.get("params", {})
                name = params.get("name")
                args = params.get("arguments", {})
                import aiohttp

                url = (
                    f"http://{self.config.host}:{self.config.port}"
                    f"/mcp/tools/{name}"
                )
                async with aiohttp.ClientSession() as session:
                    async with session.post(url, json=args) as resp:
                        tool_result = await resp.json()
                result = {
                    "content": [
                        {"type": "text", "text": json.dumps(tool_result)}
                    ]
                }
            else:
                return {
                    "jsonrpc": "2.0",
                    "id": msg_id,
                    "error": {"code": -32601, "message": "method not found"},
                }
            return {"jsonrpc": "2.0", "id": msg_id, "result": result}

        self.webserver.register_route("/mcp", ("POST",), rpc_handler)
        self.webserver._ensure_started()


def _json_type(dtype) -> str:
    from pathway_tpu_torch.internals import dtype as dt

    core = dt.unoptionalize(dtype)
    if core is dt.INT:
        return "integer"
    if core is dt.FLOAT:
        return "number"
    if core is dt.BOOL:
        return "boolean"
    if core is dt.STR:
        return "string"
    return "object"


@dataclass
class PathwayMcp:
    """Declarative MCP wiring (reference: mcp_server.py PathwayMcp:237)."""

    name: str = "pathway-mcp"
    transport: str = "streamable-http"
    host: str = "127.0.0.1"
    port: int = 8123
    serve: List[McpServable] = field(default_factory=list)

    def __post_init__(self):
        config = McpConfig(
            name=self.name,
            transport=self.transport,
            host=self.host,
            port=self.port,
        )
        server = McpServer.get(config)
        for servable in self.serve:
            servable.register_mcp(server)

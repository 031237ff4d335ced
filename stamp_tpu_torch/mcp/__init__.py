"""The MCP server of the port (``python -m stamp_tpu_torch.mcp.server``):
LLM-agent access to the pipeline, counterpart of ``stamp_tpu.mcp``."""

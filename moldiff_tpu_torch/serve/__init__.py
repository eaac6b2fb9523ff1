"""Molecule generation over HTTP (moldiff_tpu/serve)."""
from .server import SamplerService, build_service_from_checkpoint, make_http_server

__all__ = ["SamplerService", "build_service_from_checkpoint", "make_http_server"]

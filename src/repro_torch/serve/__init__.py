"""Serving substrate: prefill/decode engine + continuous batcher."""

from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine

__all__ = ["ContinuousBatcher", "Request", "ServeEngine"]

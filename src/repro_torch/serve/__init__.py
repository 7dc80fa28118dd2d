"""Churn-tolerant continuous-batching decode over live seed-reconstructed
weights (the port of ``repro/serve``)."""
from repro_torch.serve.bridge import LiveUpdateBridge
from repro_torch.serve.paged_cache import PageAllocator, bucket_pages, \
    pages_needed
from repro_torch.serve.scheduler import SAMPLING_KINDS, Request, Scheduler, \
    ServeConfig
from repro_torch.serve.server import DecodeServer
from repro_torch.serve.sim import ServeSwarmSim

__all__ = [
    "LiveUpdateBridge",
    "PageAllocator", "bucket_pages", "pages_needed",
    "SAMPLING_KINDS", "Request", "Scheduler", "ServeConfig",
    "DecodeServer",
    "ServeSwarmSim",
]

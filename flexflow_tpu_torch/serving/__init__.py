"""Continuous-batching generation on the paged KV pool: the serving
slice of the PyTorch port (flexflow_tpu/serving)."""
from .kv_pool import KVPool
from .scheduler import ContinuousScheduler, PagedKVDecodeModel
from .server import serve_http

__all__ = ["KVPool", "ContinuousScheduler", "PagedKVDecodeModel",
           "serve_http"]

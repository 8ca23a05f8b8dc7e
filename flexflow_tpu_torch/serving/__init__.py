"""Continuous-batching generation on the paged KV pool, with speculative
decoding (n-gram and draft-model proposers verified in one dispatch): the
serving slice of the PyTorch port (flexflow_tpu/serving)."""
from .kv_pool import KVPool
from .scheduler import ContinuousScheduler, PagedKVDecodeModel
from .server import serve_http
from .speculative import (AdaptiveK, DraftModelProposer, NGramProposer,
                          Proposer, build_proposer)

__all__ = ["KVPool", "ContinuousScheduler", "PagedKVDecodeModel",
           "serve_http", "Proposer", "NGramProposer", "DraftModelProposer",
           "AdaptiveK", "build_proposer"]

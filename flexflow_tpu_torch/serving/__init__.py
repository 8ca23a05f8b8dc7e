"""Continuous-batching generation on the paged KV pool, with speculative
decoding (n-gram and draft-model proposers verified in one dispatch),
and the replicated front: N supervised replicas behind one admission
queue, with the mid-decode handoff that streams a paused generation's
KV blocks to another replica: the serving slice of the PyTorch port
(flexflow_tpu/serving)."""
from .disagg import MigrationCostModel
from .front import FrontRequest, ServiceUnavailable, ServingFront
from .kv_pool import KVPool
from .kv_transfer import (BlobStoreFabric, InProcessFabric, KVMigrator,
                          KVTransferFabric, resolve_kv_transfer)
from .replica import ServingReplica, SupervisedDecodeModel
from .scheduler import ContinuousScheduler, PagedKVDecodeModel
from .server import serve_http
from .speculative import (AdaptiveK, DraftModelProposer, NGramProposer,
                          Proposer, build_proposer)

__all__ = ["KVPool", "ContinuousScheduler", "PagedKVDecodeModel",
           "serve_http", "ServingFront", "ServingReplica",
           "SupervisedDecodeModel", "FrontRequest", "ServiceUnavailable",
           "MigrationCostModel", "KVTransferFabric", "KVMigrator",
           "InProcessFabric", "BlobStoreFabric", "resolve_kv_transfer",
           "Proposer", "NGramProposer", "DraftModelProposer", "AdaptiveK",
           "build_proposer"]

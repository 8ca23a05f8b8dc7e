"""Topology: the per-tier collective cost records (`comm`) the
simulator and the searches share, the two-level slice hierarchy of
a multi-node run (`hierarchy`: `SliceHierarchy`, the placement helpers
and `expand_mesh_axes`), and the blob-store rendezvous (`rendezvous`)."""
from .rendezvous import (RENDEZVOUS_PREFIX, clear_rendezvous,
                         epoch_rendezvous, health_census, post_and_agree)

__all__ = ["RENDEZVOUS_PREFIX", "clear_rendezvous", "epoch_rendezvous",
           "health_census", "post_and_agree"]

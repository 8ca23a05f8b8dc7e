"""Topology: the per-tier collective cost records (`comm`) the
simulator and the searches share, and the two-level slice hierarchy of
a multi-node run (`hierarchy`: `SliceHierarchy`, the placement helpers
and `expand_mesh_axes`)."""

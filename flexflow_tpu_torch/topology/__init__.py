"""Topology: the per-tier collective cost records (`comm`) the
simulator and the searches share."""

"""The parallelism IR (parallel ops), machine views and pipeline
planning of the strategy search."""

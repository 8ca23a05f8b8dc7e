"""The parallelism IR (parallel ops), machine views and their lowering
onto a torch.distributed group, the collectives and per-op plans of the
sharded step, ring attention, the ZeRO ladder's layouts, and pipeline
planning for the strategy search."""

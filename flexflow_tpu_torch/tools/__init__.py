"""The operator tools (flexflow_tpu's tools/), over the port's own files.

Each reads what a run of the port writes and prints what the
reference's tool prints for the same input, with the same arguments and
exit codes:

  * `pb_to_json`           - a binary TASO catalog (.pb) to its JSON twin;
  * `substitutions_to_dot` - a rule catalog as Graphviz dot;
  * `telemetry_summary`    - a `run_telemetry.jsonl` as a table;
  * `checkpoint_fsck`      - both checkpoint tiers verified offline (the
                             npz steps, and CheckpointManager's DCP
                             steps, which only the port writes);
  * `strategy_store_import`- the shipped strategies promoted into a
                             StrategyStore under the port's keys;
  * `check_metric_docs`    - the port's metric names against
                             docs/OBSERVABILITY.md.

Run one as `python -m flexflow_tpu_torch.tools.<name> [args]`; each has
`main(argv) -> int`.  The tools read files on the host: none of them
touches a card (strategy_store_import reads the card's name for the
store key when its `--device` is CUDA, as compile does).
"""

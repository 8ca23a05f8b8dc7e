"""Machine models, the simulator, the task-graph event simulator and the
overlap calibration of the strategy search."""

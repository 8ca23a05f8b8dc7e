"""Dynamic recompilation (flexflow_tpu/recompile.py, the reference's
RecompileState and FFModel::recompile_on_condition).

A trigger reads what the run shows (a Cache op's staleness score,
ops/moe.py) and an alter hook changes the model, usually by calling
`FFModel.recompile` with another strategy or set of ranks; training then
goes on with the weights, the optimizer's slots, the op state and the
generator carried over.
"""
from __future__ import annotations

from typing import Callable


class RecompileState:
    """The trigger and alter hooks, and how often alter ran."""

    def __init__(self, trigger_func: Callable[[object], bool],
                 alter_func: Callable[[object], None], ff):
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.ff = ff
        self.recompilations = 0

    def trigger(self) -> bool:
        return bool(self.trigger_func(self.ff))

    def alter(self) -> None:
        self.alter_func(self.ff)
        self.recompilations += 1


def recompile_on_condition(ff, r: RecompileState) -> bool:
    """r.alter() when r.trigger() holds; whether it ran."""
    if r.trigger():
        r.alter()
        return True
    return False

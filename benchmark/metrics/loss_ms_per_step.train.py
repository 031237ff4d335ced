"""Host milliseconds of the training step's loss a step (the training
engine: ``modeling/tasks.py``'s loss inside ``parallel/mesh.py``'s
``make_dp_train_step``), the mean self time of the port's own
``train/loss`` spans in the window, including any wait for the device
inside it (a blocking copy of the class weights).  It includes the
profiler's own cost on the host."""

from __future__ import annotations

from benchmark.harness.program import mean_self_ms

SPAN = "train/loss"


def read(trace) -> float | None:
    return mean_self_ms(trace, SPAN)

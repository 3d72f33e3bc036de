"""Device: of the card's idle time between its busy intervals in the traced
windows, the share that no ``trainer.dispatch`` span covers: the idle time
in which the host was not enqueueing steps (planning, staging, waiting)."""

from perfbench import program_spans


def read(run):
    return program_spans.idle_outside(run, "trainer.dispatch")

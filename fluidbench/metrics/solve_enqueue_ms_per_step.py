"""solve_enqueue_ms_per_step (ms/step): the host's time inside the
program's grid.solve spans over the steps of the spans' stretch (frames
with spans on and the profiler off).  Source: the program's spans.
Layer: step and solve dispatch.  Moves updates_per_s
(updates_per_s.host_paced in a host-paced cell, under the name
solve_enqueue_ms_per_step.host_paced)."""

from fluidbench import spans


def read(tr):
    p = getattr(tr, "program", None)
    if p is None or spans.SOLVE not in p.host_ns or not p.stretch_steps:
        return None
    return p.host_ns[spans.SOLVE] / 1e6 / p.stretch_steps

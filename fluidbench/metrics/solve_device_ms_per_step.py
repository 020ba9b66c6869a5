"""solve_device_ms_per_step (ms/step): the device time of the operations
launched inside the program's grid.solve spans, each linked to its
launch by correlation id (spans.attribute), over the traced slice's
steps.  Source: the program's spans.  Layer: projection solve.  Moves
updates_per_s (updates_per_s.host_paced in a host-paced cell, under the
name solve_device_ms_per_step.host_paced)."""

from fluidbench import spans


def read(tr):
    p = getattr(tr, "program", None)
    if p is None or not tr.device or not any(
            spans.name_of(k) == spans.SOLVE for k in p.events):
        return None
    return p.device_us.get(spans.SOLVE, 0.0) / 1e3 / p.steps

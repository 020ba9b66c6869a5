"""solve_launches_per_step (ops/step): the device operations (kernels,
copies, sets) launched inside the program's grid.solve spans
(spans.attribute) over the traced slice's steps.  Source: the program's
spans.  Layer: step and solve dispatch.  Moves updates_per_s
(updates_per_s.host_paced in a host-paced cell, under the name
solve_launches_per_step.host_paced)."""

from fluidbench import spans


def read(tr):
    p = getattr(tr, "program", None)
    if p is None or not tr.device or not any(
            spans.name_of(k) == spans.SOLVE for k in p.events):
        return None
    return p.ops.get(spans.SOLVE, 0) / p.steps

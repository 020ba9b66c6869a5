"""launches_per_step (ops/step): the device's kernel, copy and set
operations in the traced slice over its steps.  Each call of a hand
kernel's wrapper that the program's counters (kernels.launch_counts)
report launches at least one, so the slice must hold at least as many
operations as those calls.  Layer: step and solve dispatch.  Moves
updates_per_s (updates_per_s.host_paced in a host-paced cell, under the
name launches_per_step.host_paced)."""

from fluidbench import trace


def read(tr: trace.Slice):
    calls = sum(tr.counters.values())
    if len(tr.device) < calls:
        raise trace.IncompleteTrace(f"{len(tr.device)} device operations "
                                    f"for {calls} kernel calls")
    return len(tr.device) / tr.steps

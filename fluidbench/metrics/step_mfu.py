"""step_mfu (%): the whole step's share of the card's peak: the least
time of a step's work, by the frozen count in roofline/step.py, over the
wall time a step took in the frames of the traced run that ran without
the profiler.  Layer: grid driver.  Moves updates_per_s
(updates_per_s.host_paced in a host-paced cell, under the name
step_mfu.host_paced)."""

from fluidbench.roofline import peaks, step


def read(tr):
    plain = [s for s in tr.spans if not s[3]]
    steps = sum(s[2] for s in plain)
    if not steps:
        return None
    wall_s = sum(s[0] + s[1] for s in plain) / steps
    return 100.0 * peaks.bound_s(*step.work(tr.stam)[0])[0] / wall_s

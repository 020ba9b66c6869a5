"""enqueue_ms_per_step (ms/step): the host's time inside the calls of
run3d_python, the enqueue of each frame without its read, over the
steps, in the frames of the traced run that ran without the profiler.
Source: the harness's own span around each call.  Layer: grid driver.
Moves updates_per_s (updates_per_s.host_paced in a host-paced cell,
under the name enqueue_ms_per_step.host_paced)."""


def read(tr):
    plain = [s for s in tr.spans if not s[3]]
    steps = sum(s[2] for s in plain)
    if not steps:
        return None
    return 1e3 * sum(s[0] for s in plain) / steps

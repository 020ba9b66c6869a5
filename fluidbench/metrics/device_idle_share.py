"""device_idle_share (fraction): 1 - the union of the device's operation
intervals over the traced slice's wall time, both from the one slice.
Layer: device.  Moves updates_per_s (updates_per_s.host_paced in a host-
paced cell, under the name device_idle_share.host_paced)."""


def read(tr):
    return 1.0 - tr.busy_s() / tr.window_s

"""device_idle (%): 100 minus the share of the traced solves' wall time
that the union of device operations (kernels, copies, fills) covers, from
``torch.profiler``'s device timeline. Layer: the device."""


def read(trace):
    if not trace.window_s or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

"""device_ms_per_iter (ms/iter): milliseconds in which a device operation
ran, per LM iteration of the traced solves (the union of kernels, copies
and fills on the device timeline). Steadier than the host-clock rate,
which follows the host's launch speed. Layer: the device."""


def read(trace):
    if not trace.iterations or not trace.device_ops:
        return None
    return 1e3 * trace.busy_s / trace.iterations

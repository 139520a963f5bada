"""pcg_live_share (%): the PCG steps that did work, over the fixed trips
the traced solves ran: the sum of ``solve_ba``'s ``info["cg_iterations"]``
over their LM iterations, over those iterations times ``cg_max_iters``. The
rest are masked trips. Layer: the reduced camera system (``schur.pcg``)."""


def read(trace):
    trips = trace.iterations * trace.cg_max_iters
    if not trips:
        return None
    live = sum(sum(s["cg_iterations"]) for s in trace.solves)
    return 100.0 * live / trips

"""Bundle-adjustment back end (port of ``libwave_tpu.optim``'s BA path)."""

from libwave_tpu_torch.optim.ba import (  # noqa: F401
    BAConfig,
    BAProblem,
    BAState,
    ba_cost,
    ba_reduced_hessian,
    solve_ba,
)
from libwave_tpu_torch.optim.pose_graph import (  # noqa: F401
    BetweenBank,
    PriorBank,
    between_from_trajectory,
    pose_graph_cost,
)
from libwave_tpu_torch.optim.reprojection import (  # noqa: F401
    linearize_reprojection,
    reprojection_residual,
)

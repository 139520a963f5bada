"""Bundle-adjustment back end (port of ``libwave_tpu.optim``'s BA path)
and the host-side Schur marginalization."""

from libwave_tpu_torch.optim.ba import (  # noqa: F401
    BAConfig,
    BAProblem,
    BAState,
    ba_cost,
    ba_from_dataset,
    ba_reduced_hessian,
    solve_ba,
    solve_ba_batched,
)
from libwave_tpu_torch.optim.marginalization import (  # noqa: F401
    psd_project,
    schur_marginalize,
)
from libwave_tpu_torch.optim.pose_graph import (  # noqa: F401
    BetweenBank,
    PoseGraphConfig,
    PriorBank,
    between_from_trajectory,
    pose_graph_cost,
    solve_pose_graph,
)
from libwave_tpu_torch.optim.reprojection import (  # noqa: F401
    linearize_reprojection,
    reprojection_residual,
)

"""Factor-graph back end (port of ``libwave_tpu.optim``): bundle
adjustment, the pose graph, the host-side Schur marginalization, the
combined trajectory states with their factor banks and LM solver, and the
dense NLLS of the Ceres examples."""

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
from libwave_tpu_torch.optim.states import (  # noqa: F401
    PoseVelAccBiasState,
    PoseVelBiasState,
    PoseVelState,
)
from libwave_tpu_torch.optim.factors import (  # noqa: F401
    bias_prior_residual,
    decaying_bias_residual,
    gps_residual,
    hand_eye_residual,
    motion_residual,
    pose_prior_residual,
    solve_trajectory_gn,
    twist_prior_residual,
)
from libwave_tpu_torch.optim.nlls import (  # noqa: F401
    LMConfig,
    LMResult,
    curve_fit,
    exp_curve_residual,
    lm_solve,
    numeric_jacobian,
)

"""End-to-end pipelines (port of ``libwave_tpu.pipelines``' visual front
end, VIO, EuRoC VIO and the windowed VIO and BA solvers)."""

from libwave_tpu_torch.pipelines.euroc_vio import (  # noqa: F401
    EurocVIOParams,
    build_euroc_vio_problem,
    default_vio_config,
    run_euroc_vio,
)
from libwave_tpu_torch.pipelines.vio import (  # noqa: F401
    VIOConfig,
    VIOProblem,
    VIOState,
    solve_vio,
    solve_vio_staged,
    vio_cost,
    vio_dead_reckon,
    vio_from_sim,
    vio_marginalize_device,
    vio_reduced_hessian,
)
from libwave_tpu_torch.pipelines.windowed_vio import (  # noqa: F401
    WindowedVIOParams,
    run_euroc_vio_windowed,
)
from libwave_tpu_torch.pipelines.windowed_ba import (  # noqa: F401
    WindowedBAParams,
    solve_ba_windowed,
)
from libwave_tpu_torch.pipelines.visual_frontend import (  # noqa: F401
    FrontendParams,
    detect_and_describe,
    track_sequence,
    tracks_from_state,
)

"""Utilities shared by the port (port of ``libwave_tpu.utils``): config,
logging, timing, tracing, data I/O, angles, files, checkpoints."""

from libwave_tpu_torch.utils.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    solve_with_checkpoints,
)
from libwave_tpu_torch.utils.config import (  # noqa: F401
    ConfigError,
    config_field,
    load_config,
    validate,
)
from libwave_tpu_torch.utils.log import (  # noqa: F401
    log_error,
    log_info,
    log_warn,
)
from libwave_tpu_torch.utils.timing import Timer, tic, toc  # noqa: F401
from libwave_tpu_torch.utils.io import (  # noqa: F401
    csv2mat,
    csvcols,
    csvrows,
    mat2csv,
    matrix_from_string,
)
from libwave_tpu_torch.utils.angles import (  # noqa: F401
    wrap_to_pi,
    wrap_to_two_pi,
)
from libwave_tpu_torch.utils.file import (  # noqa: F401
    dir_exists,
    file_exists,
    path_split,
    paths_combine,
    remove_dir,
)
from libwave_tpu_torch.utils.precision import f32_matmuls  # noqa: F401

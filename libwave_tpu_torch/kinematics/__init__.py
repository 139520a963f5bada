"""Robot motion models (port of ``libwave_tpu.kinematics``; parity:
wave_kinematics): the two-wheel robot, the quadrotor and the 2-axis
gimbal, each a pure step, and the pose record."""

from libwave_tpu_torch.kinematics.two_wheel import (  # noqa: F401
    simulate_two_wheel,
    two_wheel_step,
)
from libwave_tpu_torch.kinematics.quadrotor import (  # noqa: F401
    QuadrotorParams,
    QuadrotorState,
    quadrotor_init,
    quadrotor_step,
    quadrotor_attitude_control,
    quadrotor_position_control,
)
from libwave_tpu_torch.kinematics.gimbal import (  # noqa: F401
    GimbalParams,
    GimbalState,
    gimbal_init,
    gimbal_step,
    gimbal_track_target,
)
from libwave_tpu_torch.kinematics.pose import Pose  # noqa: F401

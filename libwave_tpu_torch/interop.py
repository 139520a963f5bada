"""Carry problems, states and parameters from the JAX package into the port.

Each function takes a container of ``libwave_tpu`` after its array leaves
were converted to numpy (on the JAX side, ``jax.tree.map(np.asarray, x)``)
and returns the port's container on ``device``. They read fields by name and
never import JAX.

- :func:`from_jax_numpy`: ``BAProblem``/``BAState``;
- :func:`landmark_buffer_from_jax_numpy`, :func:`tracker_state_from_jax_numpy`:
  the front end's ``LandmarkBuffer`` and ``TrackerState``;
- :func:`desc_from_numpy`/:func:`desc_to_numpy`: descriptor banks, numpy
  uint32 words <-> the port's int32 words with the same bits;
- :func:`params_from_jax`: a parameter dataclass, field by field, into the
  port's dataclass of the same name (the front end's, ORB's, LSH's and the
  two-frame VO's);
- :func:`vo_dataset_from_jax_numpy`, :func:`pim_from_jax_numpy`,
  :func:`vio_problem_from_jax_numpy`, :func:`vio_state_from_jax_numpy`: the
  VIO slice's ``VoDataset``, ``PreintegratedImu``, ``VIOProblem`` and
  ``VIOState``;
- :func:`point_cloud_from_numpy`, :func:`se3_from_numpy`: the lidar
  slice's ``PointCloud`` and ``SE3`` (``SE3`` banks too: factor
  measurements);
- :func:`trajectory_state_from_jax_numpy`: ``PoseVelState``,
  ``PoseVelBiasState`` and ``PoseVelAccBiasState``;
- :func:`measurement_buffer_from_jax_numpy`: ``MeasurementBuffer``;
- :func:`float_index_from_jax_numpy`: a built ``FloatIndex``;
- :func:`pid_state_from_jax_numpy`, :func:`gimbal_state_from_jax_numpy`,
  :func:`quadrotor_state_from_jax_numpy`: the controllers' and simulators'
  states;
- :func:`stacked_ba_from_jax_numpy`, :func:`stacked_vio_from_jax_numpy`,
  :func:`block_pose_graph_from_jax_numpy`: the partitioned problems of the
  distributed solvers (``parallel.partition_ba_problem``,
  ``partition_vio_problem``, ``partition_pose_graph``), each block with
  the port's own landmark layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libwave_tpu_torch.containers.landmark import LandmarkBuffer
from libwave_tpu_torch.containers.measurement import MeasurementBuffer
from libwave_tpu_torch.controls.pid import PIDState
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.kinematics.gimbal import GimbalState
from libwave_tpu_torch.kinematics.quadrotor import QuadrotorState
from libwave_tpu_torch.matching.pointcloud import PointCloud
from libwave_tpu_torch.optim import pose_graph, schur
from libwave_tpu_torch.optim.ba import BAProblem, BAState
from libwave_tpu_torch.optim import states
from libwave_tpu_torch.optim.imu import PreintegratedImu
from libwave_tpu_torch.pipelines.vio import VIOProblem, VIOState
from libwave_tpu_torch.pipelines.visual_frontend import FrontendParams
from libwave_tpu_torch.pipelines.vo_frontend import VOFrontendConfig
from libwave_tpu_torch.sim.vo_dataset import VoDataset
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.vision.descriptor import BRISKParams, ORBDescriptorParams
from libwave_tpu_torch.vision.detector import FASTParams, ORBDetectorParams
from libwave_tpu_torch.vision.flann import FLANNParams
from libwave_tpu_torch.vision.flann_float import FloatIndex, FloatIndexParams
from libwave_tpu_torch.vision.matcher import MatcherParams
from libwave_tpu_torch.vision.tracker import TrackerParams, TrackerState

_PARAMS = {
    cls.__name__: cls
    for cls in (FASTParams, ORBDetectorParams, BRISKParams,
                ORBDescriptorParams, MatcherParams, TrackerParams,
                FrontendParams, FLANNParams, VOFrontendConfig,
                FloatIndexParams)
}

_STATES = {cls.__name__: cls for cls in (
    states.PoseVelState, states.PoseVelBiasState,
    states.PoseVelAccBiasState)}


def _tensor(x, device, dtype):
    if x is None:
        return None
    t = torch.tensor(np.asarray(x), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def from_jax_numpy(problem, state, device, dtype=None):
    """Port ``(problem, state)`` to ``(BAProblem, BAState)`` tensors on
    ``device``. Integer fields keep their dtype; floating fields keep
    theirs unless ``dtype`` is given. ``ell``, ``bands``, ``between``,
    ``priors`` and the marginal-prior fields come across when present."""

    def t(x):
        return _tensor(x, device, dtype)

    ell = None
    if problem.ell is not None:
        ell = ell_from_jax_numpy(problem.ell, problem.lm_idx, device)
    between = None
    if problem.between is not None:
        b = problem.between
        between = pose_graph.BetweenBank(
            i=t(b.i), j=t(b.j), dq=t(b.dq), dp=t(b.dp),
            sqrt_info=t(b.sqrt_info),
        )
    priors = None
    if problem.priors is not None:
        p = problem.priors
        priors = pose_graph.PriorBank(
            i=t(p.i), q=t(p.q), p=t(p.p), sqrt_info=t(p.sqrt_info)
        )
    bands = None
    if problem.bands is not None:
        bands = schur.BandPlan(entries=tuple(problem.bands.entries))
    ported = BAProblem(
        K=t(problem.K), pose_idx=t(problem.pose_idx), lm_idx=t(problem.lm_idx),
        uv=t(problem.uv), weight=t(problem.weight),
        free_pose=t(problem.free_pose), between=between, priors=priors,
        ell=ell, prior_Lambda=t(problem.prior_Lambda),
        prior_b=t(problem.prior_b), prior_q=t(problem.prior_q),
        prior_p=t(problem.prior_p), bands=bands,
    )
    return ported, BAState(q=t(state.q), p=t(state.p), lm=t(state.lm))


def ell_from_jax_numpy(ell, lm_idx, device) -> schur.EllLayout:
    """The port's :class:`~libwave_tpu_torch.optim.schur.EllLayout` for the
    bank ``lm_idx`` that the JAX package's layout ``ell`` describes: the
    same stable landmark order (every slot counts, as in the JAX package's
    log-shift reduce) plus the CSR offsets the reduce kernel reads."""
    return schur.build_ell_layout(np.asarray(lm_idx), len(ell.has_obs),
                                  device=device)


def desc_from_numpy(desc, device=None) -> torch.Tensor:
    """(N, W) uint32 descriptor words -> int32 tensor with the same bits,
    on ``device`` (default: the card)."""
    a = np.ascontiguousarray(np.asarray(desc, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(resolve(device))


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor words -> (N, W) numpy uint32 with the same bits."""
    return desc.detach().cpu().contiguous().numpy().view(np.uint32)


def landmark_buffer_from_jax_numpy(buf, device=None) -> LandmarkBuffer:
    """The JAX package's ``LandmarkBuffer`` (numpy leaves) on ``device``
    (default: the card)."""
    device = resolve(device)
    return LandmarkBuffer(*(
        torch.from_numpy(np.array(getattr(buf, f))).to(device)
        for f in LandmarkBuffer._fields
    ))


def tracker_state_from_jax_numpy(state, device=None) -> TrackerState:
    """The JAX package's ``TrackerState`` (numpy leaves) on ``device``; the
    uint32 descriptor bank crosses bit for bit as int32."""
    device = resolve(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    return TrackerState(
        prev_xy=t(state.prev_xy),
        prev_desc=desc_from_numpy(state.prev_desc, device),
        prev_mask=t(state.prev_mask),
        prev_ids=t(state.prev_ids),
        prev_time=t(state.prev_time),
        image_count=t(state.image_count),
        next_id=t(state.next_id),
        landmarks=landmark_buffer_from_jax_numpy(state.landmarks, device),
    )


def params_from_jax(params):
    """A front-end parameter dataclass of the JAX package (FASTParams,
    BRISKParams, MatcherParams, TrackerParams, FrontendParams, the ORB
    parameters, FLANNParams, VOFrontendConfig) as the port's dataclass of
    the same name, field by field; nested parameter dataclasses (a
    MatcherParams' ``flann`` included) cross too."""
    cls = _PARAMS[type(params).__name__]
    kw = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if dataclasses.is_dataclass(v) and type(v).__name__ in _PARAMS:
            v = params_from_jax(v)
        kw[f.name] = v
    return cls(**kw)


def vo_dataset_from_jax_numpy(ds, device=None) -> VoDataset:
    """The JAX package's ``VoDataset`` (numpy leaves) on ``device``
    (default: the card), dtypes kept."""
    device = resolve(device)
    return VoDataset(*(_tensor(getattr(ds, f), device, None)
                       for f in VoDataset._fields))


def pim_from_jax_numpy(pim, device=None, dtype=None) -> PreintegratedImu:
    """A (stacked) ``PreintegratedImu`` on ``device`` (default: the card)."""
    device = resolve(device)
    return PreintegratedImu(*(_tensor(getattr(pim, f), device, dtype)
                              for f in PreintegratedImu._fields))


def vio_problem_from_jax_numpy(problem, device=None, dtype=None) -> VIOProblem:
    """The JAX package's ``VIOProblem`` (numpy leaves) on ``device``
    (default: the card). Floating fields keep their dtype unless ``dtype``
    is given; the ELL layout is rebuilt with the CSR offsets
    (:func:`ell_from_jax_numpy`)."""
    device = resolve(device)
    kw = {}
    for f in VIOProblem._fields:
        v = getattr(problem, f)
        if f == "pim":
            v = pim_from_jax_numpy(v, device, dtype)
        elif f == "ell":
            v = None if v is None else ell_from_jax_numpy(
                v, problem.lm_idx, device)
        elif f == "pixel_sigma":
            v = float(v)
        elif f == "gravity":
            v = tuple(float(g) for g in v)
        else:
            v = _tensor(v, device, dtype)
        kw[f] = v
    return VIOProblem(**kw)


def vio_state_from_jax_numpy(state, device=None, dtype=None) -> VIOState:
    """The JAX package's ``VIOState`` (numpy leaves) on ``device``
    (default: the card)."""
    device = resolve(device)
    return VIOState(*(_tensor(getattr(state, f), device, dtype)
                      for f in VIOState._fields))


def point_cloud_from_numpy(cloud, device=None, dtype=None) -> PointCloud:
    """A ``PointCloud`` (numpy leaves, any leading batch dimensions) on
    ``device`` (default: the card); the mask stays bool, the points keep
    their dtype unless ``dtype`` is given."""
    device = resolve(device)
    return PointCloud(points=_tensor(cloud.points, device, dtype),
                      mask=_tensor(cloud.mask, device, None))


def se3_from_numpy(T, device=None, dtype=None) -> SE3:
    """An ``SE3`` (numpy leaves ``q``, ``t``) on ``device`` (default: the
    card)."""
    device = resolve(device)
    return SE3(q=_tensor(T.q, device, dtype), t=_tensor(T.t, device, dtype))


def _fields_from(cls, obj, device, dtype, nested=None):
    """``cls`` (a NamedTuple) from the same-named fields of ``obj``;
    ``nested`` maps a field to the NamedTuple class it holds."""
    nested = nested or {}
    return cls(**{
        f: (_fields_from(nested[f], getattr(obj, f), device, dtype)
            if f in nested else _tensor(getattr(obj, f), device, dtype))
        for f in cls._fields})


def trajectory_state_from_jax_numpy(state, device=None, dtype=None):
    """A combined trajectory state of ``optim.states`` (numpy leaves) as
    the port's class of the same name on ``device`` (default: the card)."""
    return _fields_from(_STATES[type(state).__name__], state,
                        resolve(device), dtype)


def measurement_buffer_from_jax_numpy(buf, device=None,
                                      dtype=None) -> MeasurementBuffer:
    """A ``MeasurementBuffer`` (numpy leaves) on ``device`` (default: the
    card); ids, flags and the cursor keep their dtypes."""
    return _fields_from(MeasurementBuffer, buf, resolve(device), dtype)


def float_index_from_jax_numpy(index, device=None) -> FloatIndex:
    """A ``FloatIndex`` built by the JAX package (numpy leaves) on
    ``device`` (default: the card), so the port's ``float_match`` can
    query it."""
    return _fields_from(FloatIndex, index, resolve(device), None)


def pid_state_from_jax_numpy(state, device=None, dtype=None) -> PIDState:
    return _fields_from(PIDState, state, resolve(device), dtype)


def gimbal_state_from_jax_numpy(state, device=None,
                                dtype=None) -> GimbalState:
    return _fields_from(GimbalState, state, resolve(device), dtype,
                        {"pids": PIDState})


def quadrotor_state_from_jax_numpy(state, device=None,
                                   dtype=None) -> QuadrotorState:
    return _fields_from(QuadrotorState, state, resolve(device), dtype,
                        {"att_pids": PIDState, "pos_pids": PIDState})


def _stacked_layout(lm_idx, weight, num_landmarks, device):
    """The port's layouts of a stacked bank (n_blocks, Kb), one per block,
    stacked: the real slots (weight > 0) in stable landmark order, as
    ``parallel.dist_ba.partition_ell_bank`` builds them."""
    lm_idx, weight = np.asarray(lm_idx), np.asarray(weight)
    blocks = [schur.build_ell_layout(lm_idx[b], num_landmarks,
                                     valid=weight[b] > 0, device=device)
              for b in range(lm_idx.shape[0])]
    return schur.EllLayout(torch.stack([b.sigma for b in blocks]),
                           torch.stack([b.offsets for b in blocks]))


def stacked_ba_from_jax_numpy(stacked, state, device=None, dtype=None):
    """The JAX package's ``partition_ba_problem`` output (numpy leaves) as
    the port's ``(stacked BAProblem, padded BAState)`` on ``device``
    (default: the card)."""
    device = resolve(device)
    problem, st = from_jax_numpy(stacked._replace(ell=None), state, device,
                                 dtype)
    ell = _stacked_layout(stacked.lm_idx, stacked.weight, st.lm.shape[0],
                          device)
    return problem._replace(ell=ell), st


def stacked_vio_from_jax_numpy(stacked, num_landmarks: int, device=None,
                               dtype=None) -> VIOProblem:
    """The JAX package's ``partition_vio_problem`` problem (numpy leaves)
    as the port's stacked ``VIOProblem`` on ``device`` (default: the
    card); ``num_landmarks`` sizes the layouts."""
    device = resolve(device)
    problem = vio_problem_from_jax_numpy(stacked._replace(ell=None), device,
                                         dtype)
    return problem._replace(ell=_stacked_layout(
        stacked.lm_idx, stacked.obs_weight, num_landmarks, device))


def block_pose_graph_from_jax_numpy(g, device=None, dtype=None):
    """The JAX package's ``BlockPoseGraph`` (numpy leaves) as the port's,
    on ``device`` (default: the card)."""
    from libwave_tpu_torch.parallel.dist_pose_graph import BlockPoseGraph

    device = resolve(device)
    return BlockPoseGraph(*(_tensor(getattr(g, f), device, dtype)
                            for f in BlockPoseGraph._fields))

"""Planning residuals (the JAX package's mpc/residuals.py and
receding.lift_residual), for Lift, Stack, Door, PickPlace, NutAssembly,
TwoArmLift, TwoArmPegInHole and Wipe.

A residual r(env, plan_model, qpos, qvel, u, poses) -> (N, m) defines the
stage cost 0.5 ||r||^2 of the iLQR refinement: a smooth least-squares
stand-in for the env reward (same targets). `poses(model, qpos) -> (xpos,
xquat)` is the pose-only FK it reads the bodies from: the K4 wrapper where
only the value is needed, the plain kinematics.body_poses under torch.func.
"""

from __future__ import annotations

import types

import torch

from robosuite_tpu_torch.envs.two_arm import peg_alignment
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics
from robosuite_tpu_torch.utils import transforms as T


def lift_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses):
    """Reach the cube, lift it above the success height (robosuite
    lift.py:224-273 reward terms as residuals)."""
    xpos, xquat = poses(plan_model, qpos)
    eef = kinematics.site_pos(plan_model, xpos, xquat, env.eef_site)
    cube = xpos[:, env.cube_body_id]
    z_target = env.table_top_z + 0.10
    r_reach = 2.0 * (eef - cube)
    r_lift = 6.0 * torch.clamp_max(cube[:, 2:3] - z_target, 0.0)
    return torch.cat([r_reach, r_lift, 0.02 * qvel], dim=-1)


def stack_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses):
    """Reach cubeA, lift it above cubeB, align it horizontally over cubeB
    (robosuite stack.py:268-283 staged rewards as residuals)."""
    xpos, xquat = poses(plan_model, qpos)
    eef = kinematics.site_pos(plan_model, xpos, xquat, env.eef_site)
    a = xpos[:, env.cubeA_body_id]
    b = xpos[:, env.cubeB_body_id]
    r_reach = 2.0 * (eef - a)
    r_lift = 6.0 * torch.clamp_max(a[:, 2:3] - (b[:, 2:3] + 0.06), 0.0)
    r_align = 3.0 * (a[:, :2] - b[:, :2])
    return torch.cat([r_reach, r_lift, r_align, 0.02 * qvel], dim=-1)


def door_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses):
    """Reach the handle, turn the latch, open the hinge past the success
    angle (robosuite door.py:219-268 reward terms as residuals)."""
    xpos, xquat = poses(plan_model, qpos)
    eef = kinematics.site_pos(plan_model, xpos, xquat, env.eef_site)
    handle = kinematics.site_pos(plan_model, xpos, xquat, env.handle_site_id)
    hinge = qpos[:, env.hinge_qpos_addr:env.hinge_qpos_addr + 1]
    parts = [2.0 * (eef - handle), 4.0 * torch.clamp_max(hinge - 0.35, 0.0)]
    if env.use_latch:
        latch = qpos[:, env.handle_qpos_addr:env.handle_qpos_addr + 1]
        parts.append(1.5 * torch.clamp_max(latch - 1.0, 0.0))
    return torch.cat(parts + [0.02 * qvel], dim=-1)


def pick_place_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses, obj_idx=0):
    """Reach the object, lift it, carry it over its target bin quadrant
    (robosuite pick_place.py:274-372 staged rewards as residuals)."""
    xpos, xquat = poses(plan_model, qpos)
    eef = kinematics.site_pos(plan_model, xpos, xquat, env.eef_site)
    obj = xpos[:, env.obj_body_ids[obj_idx]]
    target = torch.as_tensor(env.target_bin_placements[obj_idx], dtype=qpos.dtype, device=qpos.device)
    r_reach = 2.0 * (eef - obj)
    r_lift = 5.0 * torch.clamp_max(obj[:, 2:3] - (target[2] + 0.15), 0.0)
    r_to_bin = 2.0 * (obj[:, :2] - target[:2])
    return torch.cat([r_reach, r_lift, r_to_bin, 0.02 * qvel], dim=-1)


def _pick_place_can_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses):
    # the JAX registry's row for PickPlaceCan passes obj_idx=0, the milk
    # carton (objects Milk, Bread, Cereal, Can), not the can its env rewards
    return pick_place_residual(env, plan_model, qpos, qvel, u, poses, obj_idx=0)


def nut_assembly_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses, nut_idx=0):
    """Reach nut `nut_idx`, lift it 15 cm above its peg's centre, hover it
    over the peg (robosuite nut_assembly.py:249-334 in smooth form). The
    JAX registry passes nut_idx=0, the square nut, for every variant."""
    xpos, xquat = poses(plan_model, qpos)
    eef = kinematics.site_pos(plan_model, xpos, xquat, env.eef_site)
    nut = xpos[:, env.nut_body_ids[nut_idx]]
    peg = xpos[:, [env.peg1_body_id, env.peg2_body_id][nut_idx]]
    r_reach = 2.0 * (eef - nut)
    r_lift = 5.0 * torch.clamp_max(nut[:, 2:3] - (peg[:, 2:3] + 0.15), 0.0)
    r_hover = 2.0 * (nut[:, :2] - peg[:, :2])
    return torch.cat([r_reach, r_lift, r_hover, 0.02 * qvel], dim=-1)


def wipe_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses, press_target=0.003):
    """Reach the markers' centroid in the table plane while holding a target
    tool-table penetration (the planning stand-in for a pressing force),
    from the narrowphase of the tool-table pairs alone (the JAX
    wipe_residual)."""
    xpos, xquat = poses(plan_model, qpos)
    eef = kinematics.site_pos(plan_model, xpos, xquat, env.eef_site)
    centroid = xpos[:, env.marker_body_ids].mean(dim=1)
    geom_xpos, geom_xmat = kinematics.geom_poses(plan_model, xpos, xquat)
    con = C.narrowphase(plan_model, types.SimpleNamespace(geom_xpos=geom_xpos, geom_xmat=geom_xmat),
                        pairs=set(env._tool_table_pairs))
    pen = -con["dist"].min(dim=-1).values  # > 0 when pressing
    r_reach = 3.0 * (eef[:, :2] - centroid[:, :2])
    r_press = 40.0 * (pen - press_target)[:, None]
    return torch.cat([r_reach, r_press, 0.02 * qvel], dim=-1)


def two_arm_lift_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses):
    """Both eefs to their pot handles, the pot above the success height and
    level (robosuite two_arm_lift.py:221-300 in smooth form)."""
    xpos, xquat = poses(plan_model, qpos)
    h0, h1, e0, e1 = (kinematics.site_pos(plan_model, xpos, xquat, s)
                      for s in (*env.handle_site_ids, *env.eef_sites))
    pot = xpos[:, env.pot_body_id]
    z_target = float(env.table_offset[2]) + 0.15
    r_lift = 6.0 * torch.clamp_max(pot[:, 2:3] - z_target, 0.0)
    # level: the pot's z axis along the world's (two_arm_lift.py:480-490)
    r_level = 2.0 * (T.quat2mat_wxyz(xquat[:, env.pot_body_id])[:, 2, 2:3] - 1.0)
    return torch.cat([2.0 * (e0 - h0), 2.0 * (e1 - h1), r_lift, r_level, 0.02 * qvel], dim=-1)


def two_arm_peg_in_hole_residual(env, plan_model, qpos, qvel, u, poses=kinematics.body_poses):
    """The hole-frame alignment terms t, d and cos
    (two_arm_peg_in_hole.py:440-487)."""
    xpos, xquat = poses(plan_model, qpos)
    hole, peg = env.plate_body_id, env.peg_body_id
    t, d, cos = peg_alignment(xpos[:, hole], T.quat2mat_wxyz(xquat[:, hole]), xpos[:, peg],
                              T.quat2mat_wxyz(xquat[:, peg]))
    return torch.cat([2.0 * d[:, None], torch.abs(t)[:, None], 2.0 * (cos - 1.0)[:, None], 0.02 * qvel], dim=-1)


_RESIDUALS = {"Lift": lift_residual, "Stack": stack_residual, "Door": door_residual,
              "PickPlace": pick_place_residual, "PickPlaceCan": _pick_place_can_residual,
              "PickPlaceSingle": pick_place_residual, "PickPlaceMilk": pick_place_residual,
              "PickPlaceBread": pick_place_residual, "PickPlaceCereal": pick_place_residual,
              "NutAssembly": nut_assembly_residual, "NutAssemblySingle": nut_assembly_residual,
              "NutAssemblySquare": nut_assembly_residual, "NutAssemblyRound": nut_assembly_residual,
              "TwoArmLift": two_arm_lift_residual, "TwoArmPegInHole": two_arm_peg_in_hole_residual,
              "Wipe": wipe_residual}


def residual_for(env):
    """The planning residual of env's class, or None when not ported."""
    return _RESIDUALS.get(type(env).__name__)

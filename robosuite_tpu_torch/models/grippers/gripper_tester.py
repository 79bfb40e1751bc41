"""Gripper test harness (robosuite models/grippers/gripper_tester.py; the
JAX package's gripper_tester.py): a gripper hanging over a box on a
vertical slide lowers, closes its fingers and lifts, and the box's height
before and after the lift says whether it was held. Its tendons and
equality constraints come with it, so it exercises the Robotiq, Jaco and
XArm7 finger couplings.

    t = GripperTester("XArm7Gripper", device="cpu")
    out = t.run()   # {"z_before_lift", "z_after_lift", "lifted", "finite"}

The world steps through physics/engine.step: on CUDA its kernels (K1, K2),
on the CPU their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.grippers import gripper_factory
from robosuite_tpu_torch.models.objects import BoxObject
from robosuite_tpu_torch.models.tasks import make_world_option


class GripperTester:
    def __init__(self, gripper_name: str, box_size=(0.018, 0.018, 0.018), gripper_low_pos=0.185, device="cuda"):
        self.gripper = gripper_factory(gripper_name, idn=0, arm="right")
        ms = S.ModelSpec("gripper_test", make_world_option())
        w = ms.worldbody
        w.add_geom(S.GeomSpec("floor", type="plane", size=(1, 1, 0.1)))
        # the gripper hangs from a vertical slide, pointing down
        mount = w.add_body(S.BodySpec("mount", pos=(0, 0, 0.30)))
        mount.add_joint(S.JointSpec("mount_z", type="slide", axis=(0, 0, 1), damping=50.0, armature=1.0))
        mount.inertial = S.InertialSpec(mass=1.0, diaginertia=(0.01, 0.01, 0.01))
        sub = self.gripper.root_subtree()
        sub.quat = np.array([0.0, 1.0, 0.0, 0.0])
        mount.children.append(sub)
        ms.actuators.extend(self.gripper.actuators())
        ms.equalities.extend(self.gripper.equalities())
        ms.tendons.extend(self.gripper.tendons())
        ms.add_actuator(S.ActuatorSpec("lift_z", joint="mount_z", kind="position", kp=500.0, ctrlrange=(-0.3, 0.3)))
        self.box = BoxObject("obj", size=box_size, density=200.0)
        w.children.append(self.box.get_obj())

        self.model = ms.compile().to(device)
        self.lift_act = self.model.actuator_name2id("lift_z")
        self.grip_act = np.array([self.model.actuator_name2id(n) for n in self.gripper.actuator_names], dtype=int)
        self.box_qpos = self.model.jnt_qpos_slice("obj_joint0")
        self.gripper_low_pos = gripper_low_pos

    def initial_state(self):
        """One scenario (batch 1): the box under the gripper, the fingers at
        the gripper's init_qpos."""
        from robosuite_tpu_torch.physics.state import State

        m = self.model
        qpos = m.qpos0.detach().cpu().numpy().copy()
        qpos[self.box_qpos.start:self.box_qpos.start + 3] = [0, 0, 0.019]
        for n, v in zip(self.gripper.joint_names, np.asarray(self.gripper.init_qpos)):
            qpos[m.jnt_qposadr[m.jnt_name2id(n)]] = v
        q = torch.as_tensor(qpos, dtype=torch.float32, device=m.device)[None]
        return State(qpos=q, qvel=torch.zeros(1, m.nv, device=m.device), time=torch.zeros(1, device=m.device))

    def ctrl(self, lift, grip_cmd):
        """(1, nu) controls: the slide's target and the gripper's actuators
        at the middle of their range plus grip_cmd (in [-1, 1], times each
        actuator's direction) of its half-width."""
        m = self.model
        c = np.zeros(m.nu, dtype=np.float32)
        c[self.lift_act] = lift
        rng = m.actuator_ctrlrange.detach().cpu().numpy()[self.grip_act]
        bias, weight = 0.5 * (rng[:, 1] + rng[:, 0]), 0.5 * (rng[:, 1] - rng[:, 0])
        c[self.grip_act] = bias + weight * np.clip(self.gripper.format_action_direction() * grip_cmd, -1, 1)
        return torch.as_tensor(c, device=m.device)[None]

    def run(self, n_steps_per_phase=150):
        """Lower, close, lift (n_steps_per_phase substeps each, the lift
        twice as long); -> the box's height before and after the lift,
        whether it rose 5 cm, and whether the state stayed finite."""
        from robosuite_tpu_torch.physics import engine

        state = self.initial_state()
        for lift, grip, n in ((-self.gripper_low_pos, -1.0, n_steps_per_phase),
                              (-self.gripper_low_pos, 1.0, n_steps_per_phase)):
            state = engine.step_n(self.model, state, self.ctrl(lift, grip), n // 25 * 25)
        z_before = float(state.qpos[0, self.box_qpos.start + 2])
        state = engine.step_n(self.model, state, self.ctrl(0.15, 1.0), 2 * n_steps_per_phase // 25 * 25)
        z_after = float(state.qpos[0, self.box_qpos.start + 2])
        return {"z_before_lift": z_before, "z_after_lift": z_after, "lifted": z_after > z_before + 0.05,
                "finite": bool(torch.isfinite(state.qpos).all())}

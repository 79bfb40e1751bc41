"""robosuite_tpu_torch: the PyTorch/CUDA port of robosuite_tpu.

`make("Lift", robots="Panda", reward_shaping=True)` (or `make("Stack",
robots="Panda", controller_configs="JOINT_POSITION")`, `make("Door",
robots="Panda", reward_shaping=True, seed=0)`, `make("PickPlaceCan",
robots="Sawyer", controller_configs="JOINT_POSITION")` or
`make("TwoArmLift", robots=("Panda", "Panda"))`, `make("TwoArmPegInHole",
robots=("Panda", "Panda"))`, `make("NutAssemblySingle", robots="Panda")`,
`make("Wipe", robots="Panda", controller_configs={"right": {"type":
"OSC_POSE", "impedance_mode": "variable_kp"}})`, `make("ToolHang",
robots="Panda")`, `make("TwoArmHandover", robots=("Panda", "Panda"))` or
`make("TwoArmTransport", robots=("Panda", "Panda"))`) builds a batched
env on the GPU (pass device="cpu" for the plain PyTorch path on the CPU);
its hot loop runs hand-written CUDA kernels (csrc/) built with nvcc at
first use.
"""

from robosuite_tpu_torch.envs import (  # noqa: F401  (registers the envs)
    door, lift, nut_assembly, pick_place, stack, tool_hang, two_arm, two_arm_transport, wipe)
from robosuite_tpu_torch.envs.base import REGISTERED_ENVS, make  # noqa: F401

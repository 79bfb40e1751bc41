"""Global configuration constants (robosuite macros.py:11-59), copied from
the JAX package's macros."""

# Physics timestep stamped into every compiled world (robosuite macros.py:11,
# models/world.py:14-15). 500 Hz.
SIMULATION_TIMESTEP = 0.002

# Default policy frequency (robosuite environments/base.py:102).
DEFAULT_CONTROL_FREQ = 20

# Default episode length in policy steps (robosuite environments/base.py:99).
DEFAULT_HORIZON = 1000

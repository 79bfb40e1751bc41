"""Receding-horizon MPC on the port's batched envs: MPPI sampling, iLQR
refinement and the receding harness (the JAX package's mpc/)."""

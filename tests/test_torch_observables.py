"""The Observable pipeline (robosuite_tpu_torch/observables.py) and
step_batch, the RL entry point, against the JAX package on the CPU.

  * the pipeline on batched values over six steps, each scenario at its
    own step count: a deterministic corrupter, a filter, a delay, a
    sampling rate (update_every), an inactive and a disabled observable,
    two modalities: every value and the '<modality>-state' vectors equal
    to the JAX compute_observables run scenario by scenario, exactly;
  * the uniform and gaussian noise corrupters by their mean and spread
    over 200,000 draws, against the distribution and the JAX corrupters';
    a noise corrupter with no generator raises, and so does
    use_camera_obs=True;
  * a delay set through modify_observable on the env: the observation
    seen one step late;
  * step_batch over 5 policy steps on Lift and on Stack from the JAX reset
    states injected, horizon 3: observations, reward and done as
    tests/test_torch_door.py holds Door's (whose test also holds the eef
    force and torque with a finger pad pressing on the handle).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import observables as O
from robosuite_tpu_torch.ops import forward
from tests.test_torch_door import hold_obs, jax_step_batch, one_thread  # noqa: F401  (an autouse fixture)


def _specs(lib):
    """The same observables built from either package's module."""

    def sense(key, modality):
        return lib.sensor(modality)(lambda ctx: ctx[key])

    return [
        lib.Observable("a", sense("a", "m1"), corrupter=lib.create_deterministic_corrupter(0.5),
                       filter=lambda v: 2.0 * v, delay=2),
        lib.Observable("b", sense("b", "m1"), update_every=3),
        lib.Observable("c", sense("c", "m2")),
        lib.Observable("d", sense("d", "m2"), active=False, delay=1),
        lib.Observable("e", sense("e", "m1"), enabled=False),
    ]


def test_pipeline_matches_jax_exactly():
    import robosuite_tpu.observables as JO

    B, steps = 3, 6
    rng = np.random.default_rng(0)
    raw = [{"a": rng.standard_normal((B, 3)).astype(np.float32), "b": rng.standard_normal((B, 2)).astype(np.float32),
            "c": rng.standard_normal((B,)).astype(np.float32), "d": rng.standard_normal((B, 4)).astype(np.float32),
            "e": rng.standard_normal((B, 1)).astype(np.float32)} for _ in range(steps)]
    t0 = np.array([0, 1, 2], np.int32)  # each scenario at its own step count
    specs_p, specs_j = _specs(O), _specs(JO)
    cache_p, caches_j = None, [None] * B
    for i in range(steps):
        t = t0 + i
        obs_p, cache_p = O.compute_observables(specs_p, {k: torch.as_tensor(v) for k, v in raw[i].items()}, None,
                                               torch.as_tensor(t), cache=cache_p)
        assert set(obs_p) == {"a", "b", "c", "m1-state", "m2-state"}
        for b in range(B):
            obs_j, caches_j[b] = JO.compute_observables(specs_j, {k: jnp.asarray(v[b]) for k, v in raw[i].items()},
                                                        jax.random.PRNGKey(0), jnp.asarray(t[b]), cache=caches_j[b])
            assert set(obs_j) == set(obs_p)
            for k in obs_j:
                np.testing.assert_array_equal(obs_p[k][b].numpy(), np.asarray(obs_j[k]).reshape(obs_p[k][b].shape),
                                              err_msg=f"step {i} scenario {b}: {k}")
    # the delay is the raw value two steps back, corrupted and filtered
    np.testing.assert_allclose(obs_p["a"].numpy(), 2.0 * (raw[steps - 3]["a"] + 0.5), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["uniform", "gaussian"])
def test_noise_corrupters_mean_and_spread(kind):
    import robosuite_tpu.observables as JO

    n = 200_000
    if kind == "uniform":
        lo, hi = -0.3, 0.1
        fp, fj = O.create_uniform_noise_corrupter(lo, hi), JO.create_uniform_noise_corrupter(lo, hi)
        mean, std = 0.5 * (lo + hi), (hi - lo) / np.sqrt(12.0)
    else:
        mean, std = 0.1, 0.2
        fp, fj = O.create_gaussian_noise_corrupter(mean, std), JO.create_gaussian_noise_corrupter(mean, std)
    x_p = fp(torch.zeros(n), torch.Generator().manual_seed(0)).numpy()
    x_j = np.asarray(fj(jnp.zeros(n), jax.random.PRNGKey(0)))
    for x in (x_p, x_j):  # 5 standard errors of the mean; the spread within 1%
        assert abs(float(x.mean()) - mean) < 5 * std / np.sqrt(n)
        assert abs(float(x.std()) - std) < 0.01 * std
    if kind == "uniform":
        assert float(x_p.min()) >= lo and float(x_p.max()) <= hi
    with pytest.raises(ValueError, match="Generator"):
        fp(torch.zeros(3), None)


def test_camera_obs_and_unseeded_noise_raise():
    import robosuite_tpu_torch

    with pytest.raises(NotImplementedError, match="renderer"):
        robosuite_tpu_torch.make("Lift", robots="Panda", use_camera_obs=True, device="cpu", seed=0)
    env = robosuite_tpu_torch.make("Lift", robots="Panda", device="cpu", seed=0)
    env.modify_observable("robot0_eef_pos", corrupter=O.create_gaussian_noise_corrupter(0.0, 0.01))
    g = torch.Generator().manual_seed(0)
    states, obs = env.reset_batch(2, g)
    clean = env._get_observations(states.physics, forward.forward_products(env.model, states.physics.qpos,
                                                                           states.physics.qvel)[0])
    assert float((obs["robot0_eef_pos"] - clean["robot0_eef_pos"]).abs().max()) > 0.0
    with pytest.raises(ValueError, match="Generator"):
        env.step_batch(states, torch.zeros(2, env.action_dim))
    env.step_batch(states, torch.zeros(2, env.action_dim), g)


def test_modify_observable_delays_in_env():
    """cube_pos with delay=1 through the env: the delay line starts at the
    first step (the JAX pipeline's rule: the reset keeps no history), so
    step 1 sees its own clean value and every later step the one before."""
    import robosuite_tpu_torch

    env = robosuite_tpu_torch.make("Lift", robots="Panda", device="cpu", seed=0)
    env.modify_observable("cube_pos", delay=1)
    states, _ = env.reset_batch(2, torch.Generator().manual_seed(0))
    assert states.obs_cache is not None
    a = torch.zeros(2, env.action_dim)
    seen = []
    for i in range(3):
        states, obs, _, _, _ = env.step_batch(states, a)
        kin = forward.forward_products(env.model, states.physics.qpos, states.physics.qvel)[0]
        seen.append(env._get_observations(states.physics, kin)["cube_pos"])
        torch.testing.assert_close(obs["cube_pos"], seen[max(i - 1, 0)], rtol=0, atol=0)
    assert not torch.equal(seen[2], seen[1])  # the cube moved: the check was not vacuous


@pytest.mark.parametrize("name", ["Lift", "Stack"])
def test_step_batch_matches_jax(name):
    import robosuite_tpu
    import robosuite_tpu_torch

    kw = dict(robots="Panda", reward_shaping=True, horizon=3)
    kw.update(seed=0) if name == "Lift" else kw.update(controller_configs="JOINT_POSITION")
    jenv, penv = robosuite_tpu.make(name, **kw), robosuite_tpu_torch.make(name, device="cpu", **kw)
    B = 2
    js, _ = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(0), B))
    ps = penv.state_from_flattened(np.asarray(jax.vmap(lambda p: p.flatten())(js.physics)))
    rng = np.random.default_rng(1)
    acts = np.clip(0.5 * rng.standard_normal((5, B, penv.action_dim)), -1, 1).astype(np.float32)
    acts[:, :, -1] = 1.0
    jstep = jax_step_batch(jenv)
    for i in range(5):
        js, jo, jr, jd, _ = jstep(js, jnp.asarray(acts[i]))
        ps, po, pr, pd, _ = penv.step_batch(ps, torch.as_tensor(acts[i]))
        assert set(po) == set(jo)
        hold_obs(penv, po, jo, 1e-4 if i == 0 else 1e-3, f"{name} step {i}")
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=1e-4 if i == 0 else 1e-3)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        assert pd.tolist() == [i + 1 >= 3] * B

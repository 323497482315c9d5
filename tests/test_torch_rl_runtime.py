"""The port's RL stack on the port's runtime, on the CPU.

One cluster runtime for the file (``init(mode="cluster")``); learners
run with ``device="cpu"`` and lease no GPU, env runners run their
module on the CPU.  The programs are the JAX package's RL tests
(``tests/test_rl.py``, ``test_impala.py``, ``test_sac.py``,
``test_rl_offline.py``, ``test_rl_multi_agent.py``) with their own
learning bars, unloosened:

- ``EnvRunnerGroup``'s rollouts against the JAX ``SingleAgentEnvRunner``
  on the same weights, on an env whose observations do not depend on
  the actions (so everything but the sampled actions is determined):
  shapes, rewards with the time-limit bootstrap ``r + gamma *
  V(final_obs)``, dones, values (1e-5 abs);
- a killed runner absorbed by ``FaultTolerantActorManager``;
- the multi-agent runner's per-module routing and a shared policy,
  then self-play PPO: both policies end above 5.0 and at least +1.0
  over their first iteration;
- offline: record/read round trip, epoch reshuffle, the
  smaller-than-batch error; BC's accuracy > 0.85 and a cloned policy
  that keeps CartPole up for > 300 steps;
- SAC on Pendulum-v1 above -400;
- marked ``slow`` as in JAX: PPO CartPole > 50, IMPALA with two
  learners and a runner kill > 50, DQN CartPole > 60.

Env factories are functions of this module, pickled by value into the
runners; they touch no jax.
"""

import dataclasses

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu import rl as jrl
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl.convert import (rl_params_from_numpy,
                                      rl_params_to_numpy)


@pytest.fixture(scope="module")
def cluster():
    # The learners here are small MLPs in this process: one intra-op
    # thread, as the runner actors have, keeps the suite's parallel test
    # workers from oversubscribing the host's cores (with torch's default
    # of a thread per core, SAC on Pendulum took 332 s under six workers
    # against 28 s alone).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runtime = rt.init(mode="cluster", num_cpus=8)
    yield runtime
    rt.shutdown()
    torch.set_num_threads(threads)


class _Clock(gym.Env):
    """Observations follow the step count alone, reward 1 a step."""

    observation_space = gym.spaces.Box(-10.0, 10.0, (4,), np.float32)
    action_space = gym.spaces.Discrete(2)

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        return self._obs(), 1.0, False, False, {}

    def _obs(self):
        t = self._t
        return np.array([np.sin(t), np.cos(t), t / 10, 0.5], np.float32)


def _clock_env():
    return gym.wrappers.TimeLimit(_Clock(), max_episode_steps=3)


def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


def _pendulum():
    import gymnasium as gym

    return gym.make("Pendulum-v1")


def _expert(obs: np.ndarray) -> int:
    """Scripted CartPole expert: push toward the pole's lean."""
    return int(3.0 * obs[2] + obs[3] > 0.0)


# ---------------------------------------------------------- runners
def test_env_runner_group_matches_the_jax_runner(cluster):
    params = jrl.JaxRLModule(jrl.RLModuleSpec(4, 2, (16,))).init(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    group = trl.EnvRunnerGroup(_clock_env, trl.RLModuleSpec(4, 2, (16,)),
                               num_runners=1, num_envs_per_runner=2,
                               gamma=0.9)
    try:
        group.set_weights(tree)
        (got,) = group.sample(7)
    finally:
        group.shutdown()
    ref = jrl.SingleAgentEnvRunner(_clock_env, jrl.RLModuleSpec(4, 2, (16,)),
                                   num_envs=2, seed=1000, gamma=0.9)
    ref.set_weights(params)
    want = ref.sample(7)
    assert got.keys() == want.keys()
    assert got["obs"].shape == (7, 2, 4) and got["actions"].shape == (7, 2)
    for k in ("obs", "dones", "last_obs"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("rewards", "values", "last_values"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    # Steps 3 and 6 truncate: r = 1 + gamma * V(obs at t = 3).
    final = np.array([np.sin(3), np.cos(3), 0.3, 0.5], np.float32)
    _, v_final = jrl.JaxRLModule(jrl.RLModuleSpec(4, 2, (16,))).\
        forward_train(params, final[None])
    np.testing.assert_allclose(got["rewards"][[2, 5]],
                               1.0 + 0.9 * float(v_final[0]), atol=1e-5)
    np.testing.assert_array_equal(got["dones"][:, 0],
                                  [0, 0, 1, 0, 0, 1, 0])


def test_a_killed_runner_is_absorbed_and_restored(cluster):
    spec = trl.RLModuleSpec(4, 2, (16,))
    group = trl.EnvRunnerGroup(_clock_env, spec, num_runners=2,
                               num_envs_per_runner=1)
    try:
        group.set_weights(rl_params_to_numpy(
            trl.TorchRLModule(spec, "cpu").state_dict()))
        assert len(group.sample(4)) == 2
        rt.kill(group.runners[0])
        # The dead runner's rollout is skipped; it is restored (with the
        # current weights) before the next iteration.
        assert len(group.sample(4)) == 1
        assert group.num_restarts == 1
        rollouts = group.sample(4)
        assert len(rollouts) == 2
        assert all(r["obs"].shape == (4, 1, 4) for r in rollouts)
        assert len(group.stats()) == 2
    finally:
        group.shutdown()


# ------------------------------------------------------- multi-agent
class TwoAgentBandit(trl.MultiAgentEnv):
    """tests/test_rl_multi_agent.py's env: two contextual bandits in one
    env; each agent earns 1 for matching its one-hot context, plus 0.5
    each when both match."""

    possible_agents = ["a0", "a1"]
    CONTEXTS = 4
    EP_LEN = 8

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._ctx = {}

    def _draw(self):
        self._ctx = {
            aid: int(self._rng.integers(self.CONTEXTS))
            for aid in self.possible_agents}
        return {aid: np.eye(self.CONTEXTS, dtype=np.float32)[c]
                for aid, c in self._ctx.items()}

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._draw(), {}

    def step(self, actions):
        hits = {aid: float(int(actions[aid]) == self._ctx[aid])
                for aid in self.possible_agents}
        bonus = 0.5 if all(hits.values()) else 0.0
        rewards = {aid: h + bonus for aid, h in hits.items()}
        self._t += 1
        done = self._t >= self.EP_LEN
        obs = self._draw()
        return obs, rewards, {"__all__": done}, {"__all__": False}, {}


def _specs():
    s = trl.RLModuleSpec(observation_dim=TwoAgentBandit.CONTEXTS,
                         action_dim=TwoAgentBandit.CONTEXTS, hidden=(32,))
    return {"p0": s, "p1": s}


def test_multi_agent_runner_routes_per_module():
    runner = trl.MultiAgentEnvRunner(
        TwoAgentBandit, trl.MultiRLModuleSpec(_specs()),
        policy_mapping_fn=lambda aid: "p0" if aid == "a0" else "p1",
        num_envs=3, seed=0)
    runner.set_weights(runner.multi.get_weights())
    out = runner.sample(num_steps=5)
    assert set(out) == {"p0", "p1"}
    for mid in ("p0", "p1"):
        assert out[mid]["obs"].shape == (5, 3, TwoAgentBandit.CONTEXTS)
        assert out[mid]["actions"].shape == (5, 3)
        assert out[mid]["rewards"].dtype == np.float32
        assert out[mid]["last_values"].shape == (3,)
    # Module p0 serves agent a0 of each env: its observations are a0's.
    np.testing.assert_array_equal(runner.slots["p0"],
                                  [(0, "a0"), (1, "a0"), (2, "a0")])


def test_multi_agent_shared_policy_mapping():
    runner = trl.MultiAgentEnvRunner(
        TwoAgentBandit, trl.MultiRLModuleSpec({"shared": _specs()["p0"]}),
        policy_mapping_fn=lambda aid: "shared", num_envs=2, seed=0)
    runner.set_weights(runner.multi.get_weights())
    out = runner.sample(num_steps=4)
    assert set(out) == {"shared"}
    assert out["shared"]["obs"].shape == (4, 4, TwoAgentBandit.CONTEXTS)


def test_multi_agent_ppo_both_policies_improve(cluster):
    algo = (trl.MultiAgentConfig()
            .environment(TwoAgentBandit)
            .multi_agent(policies=_specs(),
                         policy_mapping_fn=lambda aid:
                         "p0" if aid == "a0" else "p1")
            .env_runners(num_env_runners=1, num_envs_per_runner=4,
                         rollout_length=64)
            .learners(device="cpu")
            .training(lr=3e-3, entropy_coeff=0.0,
                      minibatch_size=128, num_epochs=4)
            .build())
    first, last = None, None
    try:
        for _ in range(12):
            last = algo.train()
            if first is None and "episode_return_mean/a0" in last:
                first = dict(last)
    finally:
        algo.stop()
    # Random play: P(hit)=0.25 -> return ~= 8*(0.25+0.5*0.0625)
    # ~= 2.25.  Learned play approaches 8*1.5 = 12.
    for aid in ("a0", "a1"):
        key = f"episode_return_mean/{aid}"
        assert last[key] > first[key] + 1.0, (first, last)
        assert last[key] > 5.0, last


# ----------------------------------------------------------- offline
def test_record_read_roundtrip(cluster, tmp_path):
    path = str(tmp_path / "rollouts")
    n = trl.record_rollouts(_cartpole, _expert, path, num_steps=600,
                            seed=0)
    assert n == 600
    data = trl.OfflineData(path)
    assert data.count() == 600
    batch = next(data.iter_batches(batch_size=128))
    assert np.stack(batch["obs"]).shape == (128, 4)
    assert len(batch["action"]) == 128
    assert set(np.unique(batch["action"])) <= {0, 1}


def test_offline_data_epochs_reshuffle(cluster, tmp_path):
    path = str(tmp_path / "small")
    trl.record_rollouts(_cartpole, _expert, path, num_steps=256, seed=2)
    data = trl.OfflineData(path, shuffle_seed=5)
    batches = list(data.iter_batches(batch_size=128, epochs=2))
    assert len(batches) == 4  # 256 rows / 128 per batch x 2 epochs
    firsts = [np.stack(b["obs"]) for b in batches[::2]]
    assert not np.array_equal(firsts[0], firsts[1])   # reshuffled
    rows = sorted(map(tuple, np.concatenate(
        [np.stack(b["obs"]) for b in batches[:2]])))
    assert len(set(rows)) == 256                      # each row once


def test_offline_data_smaller_than_batch_raises(cluster, tmp_path):
    path = str(tmp_path / "tiny")
    trl.record_rollouts(_cartpole, _expert, path, num_steps=64, seed=3)
    data = trl.OfflineData(path)
    with pytest.raises(ValueError) as ei:
        next(data.iter_batches(batch_size=256))
    assert "fewer rows" in str(ei.value)


def test_bc_learns_expert_and_plays(cluster, tmp_path):
    path = str(tmp_path / "expert")
    trl.record_rollouts(_cartpole, _expert, path, num_steps=3000, seed=1)
    algo = (trl.BCConfig()
            .offline_data(path, observation_dim=4, action_dim=2)
            .learners(device="cpu")
            .training(train_batch_size=256, updates_per_iteration=40)
            .build())
    first = algo.train()
    last = first
    for _ in range(14):
        last = algo.train()
        if last["accuracy"] > 0.95:
            break
    assert last["loss"] < first["loss"]
    assert last["accuracy"] > 0.85, last
    # The clone must play: greedy actions keep the pole up far beyond
    # random (~20 steps).
    module = trl.TorchRLModule(trl.RLModuleSpec(4, 2), "cpu")
    module.load_state_dict(rl_params_from_numpy(algo.get_weights()))
    env = _cartpole()
    total = 0
    for ep in range(3):
        obs, _ = env.reset(seed=100 + ep)
        for _ in range(500):
            act = int(module.forward_inference(
                torch.from_numpy(np.asarray(obs, np.float32))[None])[0])
            obs, reward, term, trunc, _ = env.step(act)
            total += reward
            if term or trunc:
                break
    assert total / 3 > 300, f"cloned policy scored {total / 3}"


# --------------------------------------------------------------- SAC
def test_sac_solves_pendulum(cluster):
    cfg = (trl.SACConfig()
           .environment(_pendulum, observation_dim=3, action_dim=1,
                        reward_scale=0.1)
           .env_runners(num_env_runners=1, num_envs_per_runner=4,
                        rollout_length=64)
           .learners(device="cpu")
           .training(learning_starts=500, train_batch_size=128,
                     updates_per_iteration=128))
    algo = dataclasses.replace(cfg, hidden=(64, 64)).build()
    first_seen, best = None, -np.inf
    try:
        for _ in range(140):
            r = algo.train()
            ret = r["episode_return_mean"]
            if ret != 0.0 and first_seen is None:
                first_seen = ret
            best = max(best, ret)
            if best > -400 and r["env_steps_total"] > 5000:
                break
    finally:
        algo.stop()
    assert best > -400, f"SAC never learned: best={best}, first={first_seen}"


# ------------------------------------------------- slow, as in JAX
@pytest.mark.slow
def test_ppo_cartpole_improves(cluster):
    algo = (trl.AlgorithmConfig()
            .environment(_cartpole, observation_dim=4, action_dim=2)
            .env_runners(num_env_runners=2, num_envs_per_runner=4,
                         rollout_length=128)
            .learners(device="cpu")
            .training(lr=3e-3, minibatch_size=256, num_epochs=4)
            .build())
    try:
        first = algo.train()
        assert first["env_steps_this_iter"] == 2 * 4 * 128
        returns = [first["episode_return_mean"]]
        for _ in range(19):
            returns.append(algo.train()["episode_return_mean"])
    finally:
        algo.stop()
    assert max(returns[5:]) > 50, returns
    assert max(returns) > 2.5 * returns[0], returns


@pytest.mark.slow
def test_impala_cartpole_two_learners_with_runner_kill(cluster):
    cfg = (trl.IMPALAConfig()
           .environment(_cartpole, observation_dim=4, action_dim=2)
           .env_runners(num_env_runners=2, num_envs_per_runner=4,
                        rollout_length=64)
           .learners(num_learners=2, device="cpu")
           .training(lr=5e-3, entropy_coeff=0.005))
    algo = dataclasses.replace(cfg, broadcast_interval=1).build()
    returns = []
    try:
        for i in range(40):
            res = algo.train()
            returns.append(res["episode_return_mean"])
            if i == 4:
                rt.kill(algo.env_runner_group.runners[0])
        assert res["num_env_runner_restarts"] >= 1, res
    finally:
        algo.stop()
    assert max(returns[10:]) > 50, returns
    assert max(returns) > 2.0 * max(returns[0], 10), returns


@pytest.mark.slow
def test_dqn_cartpole_improves(cluster):
    algo = (trl.DQNConfig()
            .environment(_cartpole, observation_dim=4, action_dim=2)
            .env_runners(num_env_runners=1, num_envs_per_runner=8,
                         rollout_length=64)
            .learners(device="cpu")
            .training(learning_starts=512, updates_per_iteration=64,
                      epsilon_decay_steps=6000, lr=1e-3,
                      target_sync_every=100)
            .build())
    returns = []
    try:
        for _ in range(25):
            returns.append(algo.train()["episode_return_mean"])
    finally:
        algo.stop()
    assert max(returns[10:]) > 60, returns

"""The port's RL stack (``ray_tpu_torch.rl``) against the JAX package's
(``ray_tpu.rl``), on the CPU.

Both packages get the same seeded numpy inputs and the same weights:
the JAX learner's param tree is converted with ``rl/convert.py`` into
the port's learner.  Tolerances, each stated where it is held:

- ``compute_gae`` (a numpy copy), the connector pipeline's outputs and
  ``NormalizeObs`` state, the replay buffers' samples on one
  ``default_rng``: exact;
- ``vtrace_targets``: 1e-6 abs, also in JAX's rho = c = 1 case;
- the squashed-Gaussian log-prob on the same noise: 1e-5 abs;
- the RMSprop step against ``optax.rmsprop(lr, decay=0.99, eps=0.1)``
  behind the global-norm clip, over 5 steps: 1e-6 abs (torch's own
  RMSprop, eps outside the root, misses it by far);
- one update of the PPO (1 epoch, 1 minibatch: JAX's permutation comes
  from ``jax.random``), IMPALA, DQN (double-Q), SAC (on JAX's noise) and
  BC learners: every parameter within 1e-5 abs of JAX's, the metrics
  within 1e-5 relative.

Then the deterministic cases of the JAX package's RL tests run on the
port's learners with their own thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import rl as jrl
from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import sac as jsac
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import dqn as tdqn
from ray_tpu_torch.rl import impala as timpala
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl import sac as tsac
from ray_tpu_torch.rl.convert import (rl_params_from_numpy,
                                      rl_params_to_numpy,
                                      sac_params_from_numpy,
                                      sac_params_to_numpy)

PARAM_ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def assert_trees_close(got, want, atol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=atol,
                                   err_msg=str(path))


def assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _rollout(rng, t=32, n=4, obs_dim=4, act_dim=2):
    return {
        "obs": rng.normal(size=(t, n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, act_dim, size=(t, n)),
        "rewards": rng.normal(size=(t, n)).astype(np.float32),
        "dones": (rng.random((t, n)) < 0.1).astype(np.float32),
        "logp": rng.uniform(-1.5, -0.2, (t, n)).astype(np.float32),
        "values": rng.normal(size=(t, n)).astype(np.float32),
        "last_values": rng.normal(size=n).astype(np.float32),
        "last_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
    }


def _transitions(rng, b=256, obs_dim=4, act_dim=2, continuous=False):
    actions = (rng.uniform(-1, 1, (b, act_dim)).astype(np.float32)
               if continuous else
               rng.integers(0, act_dim, b).astype(np.int32))
    return {
        "obs": rng.normal(size=(b, obs_dim)).astype(np.float32),
        "actions": actions,
        "rewards": rng.normal(size=b).astype(np.float32),
        "dones": (rng.random(b) < 0.2).astype(np.float32),
        "next_obs": rng.normal(size=(b, obs_dim)).astype(np.float32),
    }


# ------------------------------------------------------------- modules
def test_module_names_shapes_and_init_match_flax():
    spec = (4, 2, (64, 64))
    tree = _np(jrl.JaxRLModule(jrl.RLModuleSpec(*spec)).init(
        jax.random.PRNGKey(0)))
    module = trl.TorchRLModule(trl.RLModuleSpec(*spec), "cpu", seed=0)
    want = {k: tuple(v.shape)
            for k, v in rl_params_from_numpy(tree).items()}
    sd = module.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # flax Dense: truncated LeCun normal kernels (std 1/sqrt(fan_in),
    # within 2 std), zero biases.
    for name, fan_in in (("fc_0", 4), ("fc_1", 64)):
        w = sd[f"{name}.weight"]
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
        assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
        assert torch.all(sd[f"{name}.bias"] == 0)
    again = trl.TorchRLModule(trl.RLModuleSpec(*spec), "cpu", seed=0)
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k])


def test_convert_round_trips():
    tree = _np(jrl.JaxRLModule(jrl.RLModuleSpec(4, 3, (8,))).init(
        jax.random.PRNGKey(1)))
    module = trl.TorchRLModule(trl.RLModuleSpec(4, 3, (8,)), "cpu")
    module.load_state_dict(rl_params_from_numpy(tree))
    assert_trees_close(rl_params_to_numpy(module.state_dict()), tree, 0)
    sac_tree = _np(jsac.SACModule(jsac.ContinuousModuleSpec(
        3, 2, (8, 8))).init(jax.random.PRNGKey(2)))
    sac = tsac.SACModule(tsac.ContinuousModuleSpec(3, 2, (8, 8)), "cpu")
    sac.load_state_dict(sac_params_from_numpy(sac_tree))
    assert_trees_close(sac_params_to_numpy(sac.state_dict()), sac_tree, 0)


def test_forward_matches_jax():
    jm = jrl.JaxRLModule(jrl.RLModuleSpec(4, 3, (16, 16)))
    params = jm.init(jax.random.PRNGKey(3))
    tm = trl.TorchRLModule(trl.RLModuleSpec(4, 3, (16, 16)), "cpu")
    tm.load_state_dict(rl_params_from_numpy(_np(params)))
    obs = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    want_logits, want_values = jm.forward_train(params, obs)
    with torch.no_grad():
        logits, values = tm.forward_train(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-6)
    np.testing.assert_allclose(values.numpy(), want_values, atol=1e-6)
    np.testing.assert_array_equal(
        tm.forward_inference(torch.from_numpy(obs)).numpy(),
        np.asarray(jm.forward_inference(params, obs)))
    action, logp, value = tm.forward_exploration(torch.from_numpy(obs))
    all_logp = jax.nn.log_softmax(want_logits)
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(all_logp)[np.arange(32), action.numpy()],
        atol=1e-6)
    np.testing.assert_allclose(value.numpy(), want_values, atol=1e-6)


def test_exploration_follows_the_generator():
    spec = trl.RLModuleSpec(4, 3, (8,))
    obs = torch.zeros(2000, 4)
    a = trl.TorchRLModule(spec, "cpu", seed=5).forward_exploration(obs)[0]
    b = trl.TorchRLModule(spec, "cpu", seed=5).forward_exploration(obs)[0]
    assert torch.equal(a, b)
    # Zero inputs and zero biases: uniform logits, each action ~1/3.
    freq = torch.bincount(a, minlength=3).float() / 2000
    assert torch.all((freq - 1 / 3).abs() < 0.05), freq


# ---------------------------------------------------------- pure math
def test_gae_is_the_jax_function_exactly():
    rng = np.random.default_rng(4)
    roll = _rollout(rng, t=17, n=5)
    for gamma, lam in ((0.99, 0.95), (0.9, 1.0)):
        got = tlearner.compute_gae(roll, gamma, lam)
        want = jlearner.compute_gae(roll, gamma, lam)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_gae_matches_manual():
    rollout = {
        "rewards": np.array([[1.0], [1.0], [1.0]], np.float32),
        "dones": np.array([[0.0], [0.0], [1.0]], np.float32),
        "values": np.array([[0.5], [0.5], [0.5]], np.float32),
        "last_values": np.array([9.9], np.float32),  # masked by done
    }
    adv, targets = tlearner.compute_gae(rollout, gamma=0.9, lam=1.0)
    assert np.isclose(adv[2, 0], 0.5)
    assert np.isclose(adv[1, 0], 1.4)
    assert np.allclose(targets, adv + rollout["values"])


def _vtrace_inputs(rng, t=13, n=5):
    values = rng.normal(size=(t, n)).astype(np.float32)
    last_value = rng.normal(size=n).astype(np.float32)
    rewards = rng.normal(size=(t, n)).astype(np.float32)
    dones = (rng.random((t, n)) < 0.2).astype(np.float32)
    discounts = (0.9 * (1 - dones)).astype(np.float32)
    return values, last_value, rewards, discounts


@pytest.mark.parametrize("rho_clip,c_clip", [(1.0, 1.0), (0.8, 1.2),
                                             (2.0, 0.5)])
def test_vtrace_matches_jax(rho_clip, c_clip):
    rng = np.random.default_rng(5)
    values, last_value, rewards, discounts = _vtrace_inputs(rng)
    rhos = np.exp(rng.normal(0, 0.7, values.shape)).astype(np.float32)
    want = jimpala.vtrace_targets(values, last_value, rewards, discounts,
                                  rhos, rho_clip, c_clip)
    got = timpala.vtrace_targets(
        *map(torch.from_numpy, (values, last_value, rewards, discounts,
                                rhos)), rho_clip, c_clip)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_vtrace_reduces_to_nstep_returns_when_on_policy():
    """JAX's rho = c = 1 case: the port against JAX (1e-6) and against
    the numpy n-step recursion (the JAX test's 1e-4)."""
    rng = np.random.default_rng(0)
    t, n = 7, 3
    values = rng.normal(size=(t, n)).astype(np.float32)
    last_value = rng.normal(size=n).astype(np.float32)
    rewards = rng.normal(size=(t, n)).astype(np.float32)
    dones = (rng.random((t, n)) < 0.2).astype(np.float32)
    discounts = (0.9 * (1 - dones)).astype(np.float32)
    ref = np.zeros((t, n), np.float32)
    nxt = last_value
    for i in range(t - 1, -1, -1):
        ref[i] = rewards[i] + discounts[i] * nxt
        nxt = ref[i]
    vs_next = np.concatenate([ref[1:], last_value[None]], axis=0)
    for rhos in (np.ones((t, n), np.float32),
                 np.full((t, n), 7.0, np.float32)):   # clipped back to 1
        args = (values, last_value, rewards, discounts, rhos)
        vs, pg = timpala.vtrace_targets(*map(torch.from_numpy, args))
        jvs, jpg = jimpala.vtrace_targets(*args)
        np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), atol=1e-6)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jpg), atol=1e-6)
        np.testing.assert_allclose(vs.numpy(), ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            pg.numpy(), rewards + discounts * vs_next - values,
            rtol=1e-4, atol=1e-4)


def test_vtrace_targets_carry_no_gradient():
    rng = np.random.default_rng(6)
    values, last_value, rewards, discounts = _vtrace_inputs(rng)
    v = torch.from_numpy(values).requires_grad_()
    rhos = torch.ones_like(v).requires_grad_()
    vs, pg = timpala.vtrace_targets(v, torch.from_numpy(last_value),
                                    torch.from_numpy(rewards),
                                    torch.from_numpy(discounts), rhos)
    assert not vs.requires_grad and not pg.requires_grad


def test_squashed_gaussian_logp_matches_jax_on_the_same_noise():
    jspec = jsac.ContinuousModuleSpec(3, 2, hidden=(16,))
    jm = jsac.SACModule(jspec)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tsac.SACModule(tsac.ContinuousModuleSpec(3, 2, hidden=(16,)),
                        "cpu")
    tm.load_state_dict(sac_params_from_numpy(_np(params)))
    obs = np.random.default_rng(1).normal(
        scale=3.0, size=(512, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want_a, want_logp = jm.sample_action(params["actor"], obs, key)
    eps = np.array(jax.random.normal(key, (512, 2)))
    with torch.no_grad():
        a, logp = tm.sample_action(torch.from_numpy(obs),
                                   torch.from_numpy(eps))
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), atol=1e-5)
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tm.deterministic_action(torch.from_numpy(obs)).detach().numpy(),
        np.asarray(jm.deterministic_action(params["actor"], obs)),
        atol=1e-6)


def test_squashed_gaussian_logp_matches_numeric():
    """The JAX test's change-of-variables check on the port's module."""
    spec = tsac.ContinuousModuleSpec(3, 1, hidden=(16,))
    module = tsac.SACModule(spec, "cpu")
    obs = torch.zeros((512, 3))
    with torch.no_grad():
        a, logp = module.sample_action(obs)
        assert a.shape == (512, 1)
        assert torch.all(a.abs() <= 1.0)
        mean, log_std = module.actor(obs)
        log_std = torch.clamp(log_std, *spec.log_std_bounds)
        pre = torch.atanh(torch.clamp(a, -1 + 1e-6, 1 - 1e-6))
        eps = (pre - mean) / torch.exp(log_std)
        gauss = (-0.5 * (eps ** 2 + 2 * log_std
                         + np.log(2 * np.pi))).sum(-1)
        squash = torch.log(1 - torch.tanh(pre) ** 2 + 1e-9).sum(-1)
    np.testing.assert_allclose(logp.numpy(), (gauss - squash).numpy(),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------- connectors
def test_connector_pipeline_order_and_state_equal_jax():
    obs = np.random.default_rng(7).normal(size=(6, 3, 1))
    pipes = [pkg.ConnectorPipelineV2([pkg.FlattenObs(),
                                      pkg.NormalizeObs(update=True)])
             for pkg in (jrl, trl)]
    outs = [p({"obs": obs.copy()})["obs"] for p in pipes]
    outs2 = [p({"obs": obs[::-1].copy()})["obs"] for p in pipes]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs2[1], outs2[0])
    assert outs[1].shape == (6, 3) and outs[1].dtype == np.float32
    sj, st = (p.get_state() for p in pipes)
    assert st.keys() == sj.keys() and st["1"]["count"] == 12
    for k in ("mean", "m2"):
        np.testing.assert_array_equal(st["1"][k], sj["1"][k])
    # The state round-trips into a frozen pipeline (runner weight sync).
    frozen = [pkg.ConnectorPipelineV2([pkg.FlattenObs(),
                                       pkg.NormalizeObs(update=False)])
              for pkg in (jrl, trl)]
    frozen[0].set_state(sj)
    frozen[1].set_state(st)
    outs = [p({"obs": obs.copy()})["obs"] for p in frozen]
    np.testing.assert_array_equal(outs[1], outs[0])
    assert frozen[1].get_state()["1"]["count"] == 12
    # module -> env: rescale then clip, in order.
    low, high = np.array([-2.0, 0.0]), np.array([2.0, 1.0])
    acts = np.array([[-1.0, 0.5], [0.0, 2.0], [1.0, -3.0]], np.float32)
    for pkg in (jrl, trl):
        pipe = pkg.ConnectorPipelineV2([pkg.RescaleActions(low, high),
                                        pkg.ClipActions(low, high)])
        out = pipe({"actions": acts.copy()})["actions"]
        np.testing.assert_allclose(out, [[-2.0, 0.75], [0.0, 1.0],
                                         [2.0, 0.0]])


# ------------------------------------------------------- replay buffers
def test_replay_buffers_sample_like_jax():
    rng = np.random.default_rng(8)
    bufs = [(jdqn.ReplayBuffer(100, 4), tdqn.ReplayBuffer(100, 4)),
            (jsac.ContinuousReplayBuffer(100, 4, 2),
             tsac.ContinuousReplayBuffer(100, 4, 2))]
    for k, (jb, tb) in enumerate(bufs):
        for _ in range(5):     # 5 x 30 rows: the ring wraps
            tr = _transitions(rng, 30, continuous=bool(k))
            jb.add_batch(tr)
            tb.add_batch(tr)
        assert len(tb) == len(jb) == 100
        got = tb.sample(np.random.default_rng(9), 64)
        want = jb.sample(np.random.default_rng(9), 64)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_continuous_replay_roundtrip():
    buf = tsac.ContinuousReplayBuffer(128, 3, 1)
    tr = {
        "obs": np.ones((40, 3), np.float32),
        "next_obs": np.zeros((40, 3), np.float32),
        "actions": np.full((40, 1), 0.5, np.float32),
        "rewards": np.arange(40, dtype=np.float32),
        "dones": np.zeros(40, np.float32),
    }
    buf.add_batch(tr)
    assert len(buf) == 40
    s = buf.sample(np.random.default_rng(0), 16)
    assert s["actions"].shape == (16, 1)
    for _ in range(5):
        buf.add_batch(tr)
    assert len(buf) == 128  # ring wrapped


# -------------------------------------------------------------- RMSprop
def _rmsprop_runs(grad_steps, lr=6e-4):
    """Five steps of optax's chain and of the port's ClippedRMSprop from
    the same parameters and gradients."""
    params = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
              "b": np.zeros(4, np.float32)}
    opt = optax.chain(optax.clip_by_global_norm(40.0),
                      optax.rmsprop(lr, decay=0.99, eps=0.1))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = [torch.from_numpy(params["w"].copy()),
          torch.from_numpy(params["b"].copy())]
    topt = timpala.ClippedRMSprop(lr, grad_clip=40.0)
    tstate = topt.init(tp)
    for g in grad_steps:
        upd, state = opt.update({"w": jnp.asarray(g["w"]),
                                 "b": jnp.asarray(g["b"])}, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update([torch.from_numpy(g["w"].copy()),
                     torch.from_numpy(g["b"].copy())], tstate, tp)
    return jp, tp


def _grad_steps(scales):
    rng = np.random.default_rng(10)
    return [{"w": (rng.normal(size=(3, 4)) * s).astype(np.float32),
             "b": (rng.normal(size=4) * s).astype(np.float32)}
            for s in scales]


# A norm of ~90 at step 2: the clip at 40 acts.
@pytest.mark.parametrize("scales", [(1.0, 30.0, 0.1, 2.0, 0.5),
                                    (0.05,) * 5])
def test_rmsprop_puts_eps_inside_the_root_as_optax(scales):
    jp, tp = _rmsprop_runs(_grad_steps(scales))
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp["b"]),
                               rtol=0, atol=1e-6)


def test_torch_rmsprop_is_not_optax_rmsprop():
    """What the test above guards against: torch.optim.RMSprop with the
    same decay and eps (eps outside the root) ends far from optax: at
    gradients of 0.05 (an RL policy gradient's size) it moves ~3x as
    far, ``g / (0.1 |g| + 0.1)`` against ``g / sqrt(0.01 g**2 + 0.1)``."""
    steps = _grad_steps((0.05,) * 5)
    jp, _tp = _rmsprop_runs(steps)
    w = torch.nn.Parameter(torch.from_numpy(
        np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)))
    opt = torch.optim.RMSprop([w], lr=6e-4, alpha=0.99, eps=0.1)
    for g in steps:
        grads = [torch.from_numpy(g["w"]), torch.from_numpy(g["b"])]
        norm = float(torch.linalg.vector_norm(
            torch.stack([x.norm() for x in grads])))
        w.grad = grads[0] * min(1.0, 40.0 / norm)
        opt.step()
    start = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    moved_optax = np.abs(np.asarray(jp["w"]) - start).max()
    moved_torch = np.abs(w.detach().numpy() - start).max()
    assert moved_torch > 2.5 * moved_optax, (moved_torch, moved_optax)


# ------------------------------------------------- one update vs JAX
def test_ppo_update_matches_jax():
    rng = np.random.default_rng(11)
    roll = _rollout(rng, t=32, n=4)
    jl = jrl.PPOJaxLearner(jrl.RLModuleSpec(4, 2, (64, 64)),
                           jrl.PPOConfig(num_epochs=1, minibatch_size=128))
    tl = trl.PPOTorchLearner(trl.RLModuleSpec(4, 2, (64, 64)),
                             trl.PPOConfig(num_epochs=1,
                                           minibatch_size=128),
                             device="cpu")
    tl.set_weights(_np(jl.params))
    want = jl.update_from_batch(roll)
    got = tl.update_from_batch(roll)
    assert_metrics_close(got, want)
    assert_trees_close(tl.get_weights(), _np(jl.params), PARAM_ATOL)


def test_impala_update_matches_jax():
    rng = np.random.default_rng(12)
    batch = _rollout(rng, t=16, n=4)
    jl = jrl.ImpalaJaxLearner(jrl.RLModuleSpec(4, 2, (64, 64)),
                              jrl.VTraceConfig(gamma=0.9))
    tl = trl.ImpalaTorchLearner(trl.RLModuleSpec(4, 2, (64, 64)),
                                trl.VTraceConfig(gamma=0.9), device="cpu")
    tl.set_weights(_np(jl.params))
    for _ in range(2):
        want = jl.update_from_batch(batch)
        got = tl.update_from_batch(batch)
        assert_metrics_close(got, want)
        assert_trees_close(tl.get_weights(), _np(jl.params), PARAM_ATOL)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_jax(double_q):
    rng = np.random.default_rng(13)
    batch = _transitions(rng, 256)
    jl = jrl.DQNJaxLearner(jrl.RLModuleSpec(4, 2, (64, 64)),
                           jrl.DQNTrainConfig(double_q=double_q,
                                              target_sync_every=2))
    tl = trl.DQNTorchLearner(trl.RLModuleSpec(4, 2, (64, 64)),
                             trl.DQNTrainConfig(double_q=double_q,
                                                target_sync_every=2),
                             device="cpu")
    # A target network that differs from the online one, so double-Q's
    # argmax (online) and its evaluation (target) are told apart.
    online = jrl.JaxRLModule(jrl.RLModuleSpec(4, 2, (64, 64))).init(
        jax.random.PRNGKey(7))
    jl.params = online
    tl.module.load_state_dict(rl_params_from_numpy(_np(online)))
    tl.target.load_state_dict(rl_params_from_numpy(_np(jl.target_params)))
    for _ in range(3):      # the target syncs after the second update
        want = jl.update_from_batch(batch)
        got = tl.update_from_batch(batch)
        assert_metrics_close(got, want)
        assert_trees_close(tl.get_weights(), _np(jl.params), PARAM_ATOL)
    assert_trees_close(rl_params_to_numpy(tl.target.state_dict()),
                       _np(jl.target_params), PARAM_ATOL)


def _sac_noise(rng_key, b, act_dim):
    """The JAX step's draws: it splits its key into (next key, critic,
    actor) and draws ``normal(key, [B, A])`` for each sample."""
    _, k_critic, k_actor = jax.random.split(rng_key, 3)
    return tuple(torch.from_numpy(np.array(
        jax.random.normal(k, (b, act_dim)))) for k in (k_critic, k_actor))


def test_sac_update_matches_jax():
    rng = np.random.default_rng(14)
    batch = _transitions(rng, 128, obs_dim=3, act_dim=2, continuous=True)
    jl = jrl.SACJaxLearner(jrl.ContinuousModuleSpec(3, 2, (64, 64)))
    tl = trl.SACTorchLearner(trl.ContinuousModuleSpec(3, 2, (64, 64)),
                             device="cpu")
    tl.set_weights(_np(jl.params))
    tl._sync_targets()
    for _ in range(2):
        # The port's step draws its two noises with module.noise: hand
        # it JAX's draws for this step, in the same order.
        draws = iter(_sac_noise(jl._rng, 128, 2))
        tl.module.noise = lambda n: next(draws)
        want = jl.update_from_batch(batch)
        got = tl.update_from_batch(batch)
        assert_metrics_close(got, want)
        assert_trees_close(tl.get_weights(), _np(jl.params), PARAM_ATOL)
    targets = {k: rl_params_to_numpy(tl.target_params.state_dict(), k + ".")
               for k in ("q1", "q2")}
    assert_trees_close(targets, _np(jl.target_params), PARAM_ATOL)
    np.testing.assert_allclose(tl.log_alpha.item(), float(jl.log_alpha),
                               atol=1e-6)


def test_bc_update_matches_jax():
    rng = np.random.default_rng(15)
    batch = {"obs": rng.normal(size=(256, 4)).astype(np.float32),
             "action": rng.integers(0, 2, 256)}
    jl = jrl.BCJaxLearner(jrl.RLModuleSpec(4, 2, (64, 64)))
    tl = trl.BCTorchLearner(trl.RLModuleSpec(4, 2, (64, 64)), device="cpu")
    tl.module.load_state_dict(rl_params_from_numpy(_np(jl.params)))
    for _ in range(2):
        want = jl.update_from_batch(batch)
        got = tl.update_from_batch(batch)
        assert_metrics_close(got, want)
        assert_trees_close(tl.get_weights(), _np(jl.params), PARAM_ATOL)


# ------------------------------- the JAX tests' deterministic cases
def test_learner_update_reduces_loss():
    spec = trl.RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
    learner = trl.PPOTorchLearner(spec, trl.PPOConfig(minibatch_size=64,
                                                      num_epochs=2),
                                  device="cpu")
    rng = np.random.default_rng(0)
    t, n = 32, 4
    rollout = {
        "obs": rng.normal(size=(t, n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(t, n)),
        "rewards": rng.normal(size=(t, n)).astype(np.float32),
        "dones": np.zeros((t, n), np.float32),
        "logp": np.full((t, n), -0.693, np.float32),
        "values": np.zeros((t, n), np.float32),
        "last_values": np.zeros(n, np.float32),
    }
    m1 = learner.update_from_batch(rollout)
    m2 = learner.update_from_batch(rollout)
    assert np.isfinite(m1["loss"]) and np.isfinite(m2["loss"])
    assert m2["vf_loss"] < m1["vf_loss"]  # value net fits the targets


def _fake_batch(rng, t=16, n=4, obs_dim=4, act_dim=2):
    return {
        "obs": rng.normal(size=(t, n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, act_dim, size=(t, n)),
        "rewards": rng.normal(size=(t, n)).astype(np.float32),
        "dones": np.zeros((t, n), np.float32),
        "logp": np.full((t, n), -0.693, np.float32),
        "last_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
    }


def test_impala_learner_smoke():
    learner = trl.ImpalaTorchLearner(trl.RLModuleSpec(4, 2, (8,)),
                                     trl.VTraceConfig(gamma=0.9),
                                     device="cpu")
    m1 = learner.update_from_batch(
        _fake_batch(np.random.default_rng(0), t=8, n=2))
    assert np.isfinite(m1["loss"])
    assert 0 < m1["mean_rho"] < 100


def test_impala_learner_value_fits():
    learner = trl.ImpalaTorchLearner(trl.RLModuleSpec(4, 2, (16,)),
                                     trl.VTraceConfig(lr=1e-2),
                                     device="cpu")
    batch = _fake_batch(np.random.default_rng(1), t=32, n=4)
    losses = [learner.update_from_batch(batch)["vf_loss"]
              for _ in range(12)]
    assert losses[-1] < losses[0], losses


def test_dqn_learner_td_decreases():
    learner = trl.DQNTorchLearner(trl.RLModuleSpec(4, 2, (32,)),
                                  trl.DQNTrainConfig(lr=5e-3),
                                  device="cpu")
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(256, 4)).astype(np.float32)
    actions = rng.integers(0, 2, 256).astype(np.int32)
    batch = {
        "obs": obs,
        "actions": actions,
        "rewards": (obs[:, 0] * (2 * actions - 1)).astype(np.float32),
        "dones": np.ones(256, np.float32),  # pure regression to rewards
        "next_obs": rng.normal(size=(256, 4)).astype(np.float32),
    }
    tds = [learner.update_from_batch(batch)["td_abs"]
           for _ in range(30)]
    assert tds[-1] < tds[0] * 0.8, (tds[0], tds[-1])


def test_learner_update_moves_losses_and_alpha():
    spec = trl.ContinuousModuleSpec(3, 1, hidden=(32, 32))
    learner = trl.SACTorchLearner(spec, device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.normal(size=(64, 3)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (64, 1)).astype(np.float32),
        "rewards": rng.normal(size=64).astype(np.float32),
        "dones": np.zeros(64, np.float32),
        "next_obs": rng.normal(size=(64, 3)).astype(np.float32),
    }
    m1 = learner.update_from_batch(batch)
    assert set(m1) >= {"critic_loss", "actor_loss", "alpha", "entropy"}
    alphas = [m1["alpha"]]
    for _ in range(20):
        alphas.append(learner.update_from_batch(batch)["alpha"])
    # Auto-tuning moves alpha (entropy > target at init).
    assert alphas[-1] != pytest.approx(alphas[0])
    # Targets polyak-track the critics.
    critics = [*learner.module.q1.parameters(),
               *learner.module.q2.parameters()]
    assert any(not torch.equal(t, q) for t, q in
               zip(learner.target_params.parameters(), critics))


# -------------------------------------------------------- leases
def test_learner_actors_lease_a_share_of_the_card_only_on_it():
    cls, dev = tlearner.learner_actor_class(
        trl.ImpalaTorchLearner, 2, torch.device("cuda"))
    assert dev == "cuda" and cls._options["num_gpus"] == 0.5
    cls, dev = tlearner.learner_actor_class(
        trl.PPOTorchLearner, 4, torch.device("cuda", 0))
    assert dev == "cuda" and cls._options["num_gpus"] == 0.25
    cls, dev = tlearner.learner_actor_class(
        trl.PPOTorchLearner, 2, torch.device("cpu"))
    assert dev == "cpu" and cls._options["num_gpus"] is None

"""The fused rollout's plain PyTorch version vs the JAX Pallas kernel
(interpret mode), from the same packed state, weights and seed.

The hash RNG is reproducible, so obs noise and resets stay on: the state
is seeded with envs about to time out and envs about to leave the
flight box. One 1024-env tile, 4 steps. Record and state within 1e-4
(float32, other summation orders in the MLP); done / timeout flags
equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.ops import fused_rollout as jfr
from airgym_tpu_torch.ops import fused_rollout as tfr

N, H = 1024, 4
SHAPES = [(64, 18), (64, 1), (128, 64), (128, 1), (64, 128), (64, 1),
          (4, 64), (4, 1), (1, 64), (1, 1), (4, 1), (18, 1), (18, 1)]


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    pack = [rng.normal(0, 1 / np.sqrt(s[1]) if s[1] > 1 else 0.1,
                       s).astype(np.float32) for s in SHAPES]
    pack[10] = np.full((4, 1), -0.5, np.float32)             # logstd
    pack[12] = (np.abs(pack[12]) + 0.5).astype(np.float32)   # obs istd
    st = np.zeros((40, N), np.float32)
    st[0:3] = rng.uniform(-1, 1, (3, N))
    q = rng.normal(0, 0.1, (4, N))
    q[3] = 1.0
    st[3:7] = q / np.linalg.norm(q, axis=0)
    st[7:10] = rng.uniform(-0.5, 0.5, (3, N))
    st[10:13] = rng.uniform(-0.2, 0.2, (3, N))
    st[13:19] = rng.uniform(-0.1, 0.1, (6, N))
    st[19] = rng.integers(0, 100, N)
    st[19, :50] = 2397                      # time out within the window
    st[2, 50:100], st[9, 50:100] = 1.995, 1.0   # leave the box upward
    st[20] = rng.uniform(size=N) < 0.1      # fresh resets: zero thrust
    st[21:25] = rng.uniform(0, 1, (4, N))
    st[25:29] = rng.uniform(0, 0.3, (4, N))
    return st, pack


@pytest.mark.parametrize("motor_alpha,obs_noise",
                         [(0.0, True), (0.6, True), (0.0, False)])
def test_plain_rollout_matches_pallas_interpret(motor_alpha, obs_noise):
    st, pack = make_inputs()
    seed = 123456789
    jo, jr = jfr.rollout_fused_policy(
        jnp.asarray(st), jfr.PolicyPack(*map(jnp.asarray, pack)),
        jnp.array([seed], jnp.int32), H, obs_noise=obs_noise,
        interpret=True, motor_alpha=motor_alpha)
    to, tr = tfr.rollout_fused_policy(
        torch.from_numpy(st), tfr.PolicyPack(*map(torch.from_numpy, pack)),
        seed, H, obs_noise=obs_noise, motor_alpha=motor_alpha)
    jo, jr = np.asarray(jo), np.asarray(jr)
    assert tr.shape == (H, tfr.rec_len("hovering"), N) and to.shape == (40, N)
    np.testing.assert_array_equal(tr[:, 29:31].numpy(), jr[:, 29:31])
    assert jr[:, 29].sum() >= 100 and jr[:, 30].sum() >= 50
    np.testing.assert_allclose(tr[:, :29].numpy(), jr[:, :29], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(to[:29].numpy(), jo[:29], atol=1e-4, rtol=0)
    # rows the hovering step does not own pass through unchanged
    np.testing.assert_array_equal(to[29:].numpy(), st[29:])


def test_pack_policy_layout_and_refusals():
    from airgym_tpu_torch.models.actor_critic import ActorCritic
    from airgym_tpu_torch.rl.running_stats import RunningMeanStd
    model = ActorCritic(18, 4, generator=torch.Generator().manual_seed(0))
    rms = RunningMeanStd.create((18,)).update(torch.randn(64, 18))
    pack = tfr.pack_policy(model, rms)
    assert [tuple(x.shape) for x in pack] == SHAPES
    assert tfr.flat_policy(pack).numel() == sum(int(np.prod(s))
                                                for s in SHAPES)
    assert torch.equal(pack.w1, model.actor_mlp.layers[1].weight)
    np.testing.assert_allclose(
        pack.obs_istd[:, 0].numpy(),
        1 / np.sqrt(rms.var.numpy().astype(np.float32) + 1e-5), rtol=1e-6)
    assert tfr.rec_len("hovering") == 31
    st = torch.zeros((40, N))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfr.rollout_fused_policy(st, pack, 0, 1, task="avoid")
    with pytest.raises(ValueError, match="multiple of 1024"):
        tfr.rollout_fused_policy(torch.zeros((40, 512)), pack, 0, 1)


def test_kernel_build_cache_key_and_missing_nvcc(monkeypatch, tmp_path):
    from airgym_tpu_torch.kernels import build
    path = tfr.KERNEL.so_path()
    assert path == tfr.KERNEL.so_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libfused_rollout-") and path.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert tfr.KERNEL.so_path() != path           # flags are in the key
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.CudaKernel("fused_rollout", {}).lib()

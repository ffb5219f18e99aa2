"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc: they are marked ``cuda`` and skip
elsewhere (the decision is made inside the fixture). ``chip_smoke.py``
runs the same comparisons at the main paths' full shapes."""
import pytest
import torch

from airgym_tpu_torch.ops import fused_hovering as fh
from airgym_tpu_torch.ops import fused_rollout as fr
from airgym_tpu_torch.ops import fused_update as fu

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _model_and_stats(device, obs=18):
    from airgym_tpu_torch.models.actor_critic import ActorCritic
    from airgym_tpu_torch.rl.running_stats import RunningMeanStd
    g = torch.Generator().manual_seed(0)
    model = ActorCritic(obs, 4, generator=g).to(device)
    rms = RunningMeanStd.create((obs,), device).update(
        torch.randn((512, obs), device=device))
    return model, rms


@pytest.mark.parametrize("task", ["hovering", "balloon", "tracking"])
def test_rollout_kernel_matches_plain(device, task):
    from airgym_tpu_torch import envs
    t = envs.make_task(task, num_envs=2048, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    state = t.initial_state(gen)
    model, rms = _model_and_stats(device, t.num_obs)
    pack = fr.pack_policy(model, rms)
    if task == "balloon":
        packed = fr.pack_state_balloon(state.core, state.balloon,
                                       state.pre_root_pos)
        packed[29:32, 64:96] = packed[0:3, 64:96] + 0.05     # hits
    else:
        packed = fh.pack_state(state.core)
    max_len = fr._TASK_MAX_LEN[task]
    packed[19, :64] = max_len - 4.0
    before = fr.KERNEL.launches[task]
    out_k, rec_k = fr.rollout_fused_policy(packed, pack, 42, 8, task=task)
    assert fr.KERNEL.launches[task] == before + 1
    out_p, rec_p = fr.rollout_fused_policy_plain(packed, pack, 42, 8,
                                                 task=task)
    torch.cuda.synchronize()
    obs = t.num_obs
    assert torch.equal(rec_k[:, obs + 11:obs + 13], rec_p[:, obs + 11:obs + 13])
    torch.testing.assert_close(rec_k, rec_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(out_k, out_p, atol=1e-4, rtol=0)


def test_env_only_kernel_matches_plain(device):
    from airgym_tpu_torch import envs
    t = envs.make_task("hovering", num_envs=2048, device=device)
    state = t.initial_state(torch.Generator(device=device).manual_seed(2))
    packed = fh.pack_state(state.core)
    packed[19, :64] = 2390.0
    act = torch.tensor([0.1, -0.1, 0.05, 0.7], device=device)
    before = fh.KERNEL.launches["env"]
    out_k, rew_k = fh.rollout_fused(packed, act, 7, 32)
    assert fh.KERNEL.launches["env"] == before + 1
    out_p, rew_p = fh.rollout_fused_plain(packed, act, 7, 32)
    torch.cuda.synchronize()
    assert torch.equal(out_k[19:21], out_p[19:21])
    torch.testing.assert_close(out_k, out_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(rew_k, rew_p, atol=1e-3, rtol=0)


@pytest.mark.parametrize("B,nmb,obs", [(4096, 4, 18), (1000, 10, 18),
                                       (4096, 4, 48)])
def test_update_kernel_matches_plain(device, B, nmb, obs):
    """(1000, 10): minibatches of 100 samples, a ragged last block."""
    model, rms = _model_and_stats(device, obs)
    g = torch.Generator(device=device).manual_seed(2)
    x = torch.randn((B, obs), generator=g, device=device)
    with torch.no_grad():
        mu0, sigma, _ = model(x, rms)
    act = mu0 + sigma * torch.randn(mu0.shape, generator=g, device=device)
    logstd = model.logstd.detach()
    d = (act - mu0) / sigma
    nlp = 0.5 * (d * d).sum(-1) + 0.5 * 1.8378770664093453 * 4 + logstd.sum()
    named = dict(model.named_parameters())
    zero = {k: torch.zeros_like(v) for k, v in named.items()}
    cfg = dict(e_clip=0.2, critic_coef=2.0, bounds_coef=1e-4,
               entropy_coef=0.0, truncate_grads=True, grad_norm=1.5,
               adaptive_lr=True, kl_threshold=0.008, min_lr=1e-6,
               max_lr=1e-2)
    args = (rms.normalize(x), act, torch.randn((B,), generator=g,
                                               device=device),
            torch.randn((B,), generator=g, device=device), nlp, mu0,
            torch.exp(logstd).reshape(-1, 1), fu.pack_update(named),
            fu.pack_update(zero), fu.pack_update(zero),
            torch.tensor([3e-4], device=device),
            torch.zeros(1, device=device))
    k = fu.fused_update(*args, nmb=nmb, mini_epochs=2, cfg=cfg)
    p = fu.fused_update_plain(*args, nmb=nmb, mini_epochs=2, cfg=cfg)
    for a, b in zip(k[0], p[0]):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) < 2e-3 * scale + 1e-5
    torch.testing.assert_close(k[3], p[3], rtol=1e-6, atol=0)
    assert float(k[4]) == float(p[4]) == 2.0 * nmb
    for key in fu.METRICS:
        torch.testing.assert_close(k[5][key], p[5][key], rtol=5e-3,
                                   atol=5e-4)


@pytest.mark.parametrize("cull", [None, 4.5], ids=["unguarded", "guarded"])
def test_render_kernel_matches_plain(device, cull):
    """The fused render + post-process kernel on Planning's scene (40
    trees, the goal ball, the ground) after a few steps, culled or not."""
    from airgym_tpu_torch import envs
    from airgym_tpu_torch.render import raycast as rc
    t = envs.make_task("planning", num_envs=256, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    state = t.initial_state(gen)
    for _ in range(5):
        a = torch.rand((256, 4), generator=gen, device=device) - 0.5
        a[:, 3] = -0.69
        state, _ = t.step(state, a, gen, render=False)
    inp = rc.prepare(t.cam_cfg, state.core.root, t.scene(state), 99, cull)
    before = rc.KERNEL.launches["render_process"]
    out_k = rc.render_process_packed(inp)
    assert rc.KERNEL.launches["render_process"] == before + 1
    out_p = rc.render_process_packed_plain(inp)
    torch.cuda.synchronize()
    assert out_k.shape == (256, 1, 212, 120)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=0)

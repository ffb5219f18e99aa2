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
    """(1000, 10): minibatches of 100 samples over the persistent grid,
    so blocks hold one sample or none. One launch per call; two calls
    agree to the bit."""
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
    before = fu.KERNEL.launches[f"obs{obs}"]
    k = fu.fused_update(*args, nmb=nmb, mini_epochs=2, cfg=cfg)
    k2 = fu.fused_update(*args, nmb=nmb, mini_epochs=2, cfg=cfg)
    assert fu.KERNEL.launches[f"obs{obs}"] == before + 2
    p = fu.fused_update_plain(*args, nmb=nmb, mini_epochs=2, cfg=cfg)
    for a, b in zip(k[:3], k2[:3]):
        assert torch.equal(fu.flatten(a), fu.flatten(b))
    assert torch.equal(k[3], k2[3])
    assert all(torch.equal(k[5][key], k2[5][key]) for key in fu.METRICS)
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


@pytest.mark.parametrize("task,cull", [("maplanning", None),
                                       ("depthgen", None),
                                       ("depthgen", 4.5)],
                         ids=["maplanning", "depthgen", "depthgen-guarded"])
def test_render_depth_kernel_matches_plain(device, task, cull):
    """The raw depth kernel on MAPlanning's sphere scene (after a few
    steps) and on DepthGen's 168-record scene, culled or not."""
    from airgym_tpu_torch import envs
    from airgym_tpu_torch.render import raycast as rc
    t = envs.make_task(task, num_envs=64, device=device)
    gen = torch.Generator(device=device).manual_seed(4)
    state = t.initial_state(gen)
    if task == "maplanning":
        for _ in range(5):
            a = torch.rand((t.flat_n, 4), generator=gen, device=device) - 0.5
            a[:, 3] = -0.69
            state, _ = t.step(state, a, gen, render=False)
        scene = t.scene(state.core.root, state.goal)
    else:
        scene = t.scene(state)
    inp = rc.prepare(t.cam_cfg, state.core.root, scene, None, cull)
    before = rc.DEPTH_KERNEL.launches["render_depth"]
    out_k = rc.render_depth_packed(inp)
    assert rc.DEPTH_KERNEL.launches["render_depth"] == before + 1
    out_p = rc.render_depth_packed_plain(inp)
    torch.cuda.synchronize()
    assert out_k.shape == (inp.origins.shape[0], 212, 120)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=1e-6)


def _cnn_inputs(device, b, h, w, dtype, seed=5):
    from airgym_tpu_torch.experiments import fused_cnn as fc
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, h, w), generator=g, device=device).to(dtype)
    ws = []
    for k in fc.W_KEYS:
        if k in fc.MAT:
            r, c = fc.MAT[k]
            ws.append((torch.randn((r, c), generator=g, device=device)
                       / r ** 0.5).to(dtype))
        elif k[0] == "s":
            ws.append(0.5 + torch.rand(fc.ROW[k], generator=g, device=device))
        else:
            ws.append(0.2 * torch.randn(fc.ROW[k], generator=g,
                                        device=device))
    return x, ws, torch.randn((b, 64), generator=g, device=device)


@pytest.mark.parametrize("b,h,w,dtype", [
    (64, 212, 120, torch.bfloat16), (24, 212, 120, torch.float32),
    (5, 28, 20, torch.bfloat16), (3, 16, 12, torch.float32)],
    ids=["planning-bf16", "planning-f32", "ragged-bf16", "tiny-f32"])
def test_fused_cnn_kernels_match_plain(device, b, h, w, dtype):
    """The fused CNN forward and backward kernels against their plain
    versions; float32 to 2e-5 (forward) / 2e-4 (gradients) of max|ref|,
    bfloat16 to 1e-3 / 1e-2 (sums in another order flip a few bf16
    roundings of the activations and of g0 / g1 / g2); two backward runs
    agree to the bit; each wrapper counts one launch."""
    from airgym_tpu_torch import device as dv
    from airgym_tpu_torch.experiments import fused_cnn as fc
    dv.disable_tf32()
    x, ws, dp = _cnn_inputs(device, b, h, w, dtype)
    f32 = dtype == torch.float32
    before = dict(fc.KERNEL.launches)
    out_k = fc._fwd(x, ws)
    g_k = fc._bwd(x, ws, dp)
    g_k2 = fc._bwd(x, ws, dp)
    assert fc.KERNEL.launches["fused_cnn_fwd"] == \
        before.get("fused_cnn_fwd", 0) + 1
    assert fc.KERNEL.launches["fused_cnn_bwd"] == \
        before.get("fused_cnn_bwd", 0) + 2
    out_p = fc.encode_pooled_plain(x, ws)
    g_p = fc.encode_pooled_plain_bwd(x, ws, dp)
    torch.cuda.synchronize()
    scale = float(out_p.abs().max())
    assert float((out_k - out_p).abs().max()) <= (2e-5 if f32 else 1e-3) \
        * scale
    for key, a, a2, r in zip(fc.W_KEYS, g_k, g_k2, g_p):
        assert torch.equal(a, a2), key
        tol = (2e-4 if f32 else 1e-2) * float(r.abs().max())
        assert float((a - r).abs().max()) <= tol, key


def test_cnn_encoder_pallas_on_the_card(device):
    """CNNEncoder(impl='pallas') launches the kernels for CUDA tensors and
    its gradients reach the conv weights; against impl='auto' in float32
    (TF32 off) the features agree within 1e-4."""
    from airgym_tpu_torch import device as dv
    from airgym_tpu_torch.experiments import fused_cnn as fc
    from airgym_tpu_torch.models.actor_critic import CNNEncoder
    dv.disable_tf32()
    a = CNNEncoder(compute_dtype=None, impl="auto",
                   generator=torch.Generator().manual_seed(1)).to(device)
    b = CNNEncoder(compute_dtype=None, impl="pallas").to(device)
    b.load_state_dict(a.state_dict())
    img = torch.randn((16, 1, 212, 120), device=device)
    before = fc.KERNEL.launches["fused_cnn_fwd"]
    fb = b(img)
    fb.sum().backward()
    assert fc.KERNEL.launches["fused_cnn_fwd"] == before + 1
    torch.testing.assert_close(fb, a(img), atol=1e-4, rtol=0)
    assert float(b.features[0].weight.grad.abs().max()) > 0.0

"""The fused update's plain PyTorch version vs the JAX fused_update
kernel (which interprets by itself off-TPU), from the same dataset,
weights and Adam state, at 18 observation features (Hovering, Balloon)
and 48 (Tracking).

The kernel source itself, csrc/fused_update.cu, is also compiled for the
CPU against csrc/cuda_emu.h (a cooperative launch of two blocks of 256
std::threads) and held against the plain version.

Tolerances are those of tests/test_fused_update.py: params and moments
within 2e-3 * max|ref| + 1e-5 per tensor, lr to rtol 1e-6, count equal,
metrics to rtol 5e-3 / atol 5e-4."""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.ops import fused_update as jfu
from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.ops import fused_update as tfu

def shapes(obs=18):
    return [(64, obs), (64, 1), (128, 64), (128, 1), (64, 128), (64, 1),
            (5, 64), (5, 1), (4, 1)]


SHAPES = shapes(18)
BASE_CFG = dict(e_clip=0.2, critic_coef=2.0, bounds_coef=1e-4,
                entropy_coef=0.0, truncate_grads=True, grad_norm=1.5,
                adaptive_lr=True, kl_threshold=0.008, min_lr=1e-6,
                max_lr=1e-2)


def make_case(seed, B=4096, obs_dim=18):
    rng = np.random.default_rng(seed)
    sh = shapes(obs_dim)
    w = [rng.normal(0, 1 / np.sqrt(s[1]) if s[1] > 1 else 0.1,
                    s).astype(np.float32) for s in sh]
    w[8] = np.full((4, 1), -0.3, np.float32)
    m = [rng.normal(0, 1e-3, s).astype(np.float32) for s in sh]
    v = [np.abs(rng.normal(0, 1e-5, s)).astype(np.float32) for s in sh]
    obs = np.clip(rng.normal(size=(B, obs_dim)), -5, 5).astype(np.float32)
    mus0 = rng.normal(0, 0.6, (B, 4)).astype(np.float32)
    sigma0 = np.exp(w[8]).astype(np.float32)
    act = (mus0 + sigma0[:, 0] * rng.normal(size=(B, 4))).astype(np.float32)
    d = (act - mus0) / sigma0[:, 0]
    nlp = (0.5 * (d * d).sum(1) + 0.5 * np.log(2 * np.pi) * 4
           + w[8].sum()).astype(np.float32)
    data = (obs, act, rng.normal(size=B).astype(np.float32),
            rng.normal(size=B).astype(np.float32), nlp, mus0, sigma0)
    return data, w, m, v


CASES = {
    # name: (nmb, mini_epochs, lr, cfg overrides, observation features)
    "adaptive": (8, 3, 3e-4, {}, 18),
    "lr_down": (8, 3, 1e-2, {}, 18),
    "lr_up": (8, 3, 1e-6, {}, 18),
    "single_minibatch_fixed_lr": (1, 2, 3e-4, {"adaptive_lr": False}, 18),
    "entropy_no_clip": (4, 2, 3e-4, {"entropy_coef": 0.01,
                                     "truncate_grads": False}, 18),
    # Tracking's width
    "obs48_adaptive": (8, 3, 3e-4, {}, 48),
    "obs48_lr_down": (4, 2, 1e-2, {}, 48),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_update_matches_jax_kernel(case):
    nmb, me, lr0, over, obs_dim = CASES[case]
    cfg = dict(BASE_CFG, **over)
    data, w, m, v = make_case(list(CASES).index(case), obs_dim=obs_dim)
    lr = np.array([lr0], np.float32)
    count = np.array([7.0], np.float32)
    J = jfu.fused_update(*map(jnp.asarray, data),
                         jfu.UpdatePack(*map(jnp.asarray, w)),
                         jfu.UpdatePack(*map(jnp.asarray, m)),
                         jfu.UpdatePack(*map(jnp.asarray, v)),
                         jnp.asarray(lr), jnp.asarray(count), nmb=nmb,
                         mini_epochs=me, cfg=cfg)
    T = tfu.fused_update(*map(torch.from_numpy, data),
                         tfu.UpdatePack(*map(torch.from_numpy, w)),
                         tfu.UpdatePack(*map(torch.from_numpy, m)),
                         tfu.UpdatePack(*map(torch.from_numpy, v)),
                         torch.from_numpy(lr), torch.from_numpy(count),
                         nmb=nmb, mini_epochs=me, cfg=cfg)
    for k in range(3):
        for f in tfu._FIELDS:
            a = np.asarray(getattr(J[k], f))
            b = getattr(T[k], f).numpy()
            scale = max(np.abs(a).max(), 1e-3)
            assert np.abs(a - b).max() < 2e-3 * scale + 1e-5, (k, f)
    np.testing.assert_allclose(T[3].numpy(), np.asarray(J[3]), rtol=1e-6)
    assert float(T[4]) == float(J[4][0]) == 7.0 + nmb * me
    for key in tfu.METRICS:
        np.testing.assert_allclose(float(T[5][key]), float(J[5][key]),
                                   rtol=5e-3, atol=5e-4, err_msg=key)
    if case == "lr_down":
        assert float(T[3]) < lr0
    if case == "lr_up":
        assert float(T[3]) > lr0
    if not cfg["adaptive_lr"]:
        assert float(T[3]) == float(lr[0])


def test_pack_roundtrip_and_checks():
    from airgym_tpu_torch.models.actor_critic import ActorCritic
    model = ActorCritic(18, 4, generator=torch.Generator().manual_seed(1))
    named = dict(model.named_parameters())
    pack = tfu.pack_update(named)
    assert [tuple(x.shape) for x in pack] == SHAPES
    assert tfu.flatten(pack).numel() == tfu.num_params(18) == 18121
    assert tfu.num_params(48) == 20041
    assert [tuple(x.shape) for x in tfu.unflatten(
        torch.zeros(20041), 48)] == shapes(48)
    back = tfu.unpack_update(tfu.unflatten(tfu.flatten(pack), 18))
    assert set(back) == set(named)
    for k, p in named.items():
        assert torch.equal(back[k], p.detach()), k
    data, w, m, v = make_case(0, B=512)
    args = [torch.from_numpy(x) for x in data]
    packs = [tfu.UpdatePack(*map(torch.from_numpy, x)) for x in (w, m, v)]
    with pytest.raises(ValueError, match="minibatches"):
        tfu.fused_update(*args, *packs, torch.tensor([1e-3]),
                         torch.tensor([0.0]), nmb=3, mini_epochs=1,
                         cfg=BASE_CFG)
    args[0] = args[0][:, :17]
    with pytest.raises(ValueError, match="obs_n"):
        tfu.fused_update(*args, *packs, torch.tensor([1e-3]),
                         torch.tensor([0.0]), nmb=1, mini_epochs=1,
                         cfg=BASE_CFG)


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """csrc/fused_update.cu compiled with g++ against csrc/cuda_emu.h (one
    std::thread per CUDA thread, the grid barrier over all of them), as a
    CudaKernel with the wrapper's entry points."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    out = tmp_path_factory.mktemp("emu") / "libfused_update_emu.so"
    header = tfu.KERNEL.source.parent / "cuda_emu.h"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-ffp-contract=off", "-include", str(header), "-x", "c++",
                    str(tfu.KERNEL.source), "-o", str(out), "-lpthread"],
                   check=True, capture_output=True, timeout=300)
    kernel = build.CudaKernel("fused_update_emu", tfu.KERNEL.entry_points)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in kernel.entry_points.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.airgym_error_string.argtypes = [ctypes.c_int]
    lib.airgym_error_string.restype = ctypes.c_char_p
    kernel._lib = lib
    return kernel


@pytest.mark.parametrize("obs_dim", [18, 48])
def test_kernel_source_matches_plain_on_cpu(emulated_kernel, obs_dim):
    """The persistent kernel on the emulated two-SM card (G = 2): 2
    minibatches of 33 samples (blocks of 16 and 17: the second block walks
    a full chunk and a ragged one), 2 mini-epochs, the adaptive lr on,
    against the plain version; two runs bitwise equal; one launch each."""
    kernel = emulated_kernel
    g = ctypes.c_int(0)
    kernel.call("fused_update_grid", obs_dim, tfu.GRID_CAP, ctypes.byref(g))
    assert g.value == 2
    with pytest.raises(RuntimeError, match="fused_update_grid"):
        kernel.call("fused_update_grid", obs_dim, 0, ctypes.byref(g))

    nmb, me = 2, 2
    data, w, m, v = make_case(5 + obs_dim, B=66, obs_dim=obs_dim)
    args = (*map(torch.from_numpy, data),
            *(tfu.UpdatePack(*map(torch.from_numpy, x)) for x in (w, m, v)),
            torch.tensor([3e-4]), torch.tensor([7.0]))
    kw = dict(nmb=nmb, mini_epochs=me, cfg=BASE_CFG)
    before = kernel.launches[f"obs{obs_dim}"]
    runs = [tfu._kernel_update(kernel, 2, None, *args, **kw)
            for _ in range(2)]
    assert kernel.launches[f"obs{obs_dim}"] == before + 2
    ref = tfu.fused_update_plain(*args, **kw)
    got = runs[0]
    for k in range(3):
        for f in tfu._FIELDS:
            a, b = getattr(ref[k], f), getattr(got[k], f)
            scale = max(float(a.abs().max()), 1e-3)
            assert float((a - b).abs().max()) < 2e-3 * scale + 1e-5, (k, f)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-6, atol=0)
    assert float(got[4]) == float(ref[4]) == 7.0 + nmb * me
    for key in tfu.METRICS:
        torch.testing.assert_close(got[5][key], ref[5][key], rtol=5e-3,
                                   atol=5e-4)
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(tfu.flatten(a), tfu.flatten(b))
    assert all(torch.equal(runs[0][5][k], runs[1][5][k]) for k in tfu.METRICS)
    assert torch.equal(runs[0][3], runs[1][3])

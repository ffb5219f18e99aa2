"""The env-only fused Hovering rollout: its plain PyTorch version vs the
JAX Pallas kernel (interpret mode), from the same packed state, constant
action and seed, with resets and time-outs in the window.

Tolerances are those of tests/test_fused_hovering.py: root state within
1e-4 and reward sums within 1e-3 (the plain version and the Pallas kernel
round alike, so the real gap is far smaller); the reset flags equal. The
kernel source itself, csrc/fused_hovering.cu, is compiled with g++
against csrc/cuda_emu.h and held against the plain version under the
same tolerances."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.ops import fused_hovering as jfh
from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.ops import fused_hovering as tfh

N, T = 1024, 12


def make_state(seed=0):
    rng = np.random.default_rng(seed)
    st = np.zeros((40, N), np.float32)
    st[0:3] = rng.uniform(-1, 1, (3, N))
    q = rng.normal(0, 0.1, (4, N))
    q[3] = 1.0
    st[3:7] = q / np.linalg.norm(q, axis=0)
    st[7:10] = rng.uniform(-0.5, 0.5, (3, N))
    st[10:13] = rng.uniform(-0.2, 0.2, (3, N))
    st[13:19] = rng.uniform(-0.1, 0.1, (6, N))
    st[19] = rng.integers(0, 100, N)
    st[19, :64] = 2390                      # time out within the window
    st[2, 64:128], st[9, 64:128] = 1.95, 2.0    # leave the box upward
    st[20] = rng.uniform(size=N) < 0.1      # fresh resets: zero thrust
    st[21:25] = rng.uniform(0, 1, (4, N))
    st[25:29] = rng.uniform(0, 0.3, (4, N))
    st[29:40] = rng.normal(size=(11, N))    # not the step's: pass through
    return st


@pytest.mark.parametrize("motor_alpha", [0.0, 0.6])
def test_plain_env_rollout_matches_pallas_interpret(motor_alpha):
    st = make_state()
    act = np.array([0.3, -0.2, 0.1, 0.62], np.float32)
    seed = 24681357
    jo, jr = jfh.rollout_fused(jnp.asarray(st), jnp.asarray(act),
                               jnp.array([seed], jnp.int32), T,
                               interpret=True, motor_alpha=motor_alpha)
    to, tr = tfh.rollout_fused(torch.from_numpy(st), torch.from_numpy(act),
                               seed, T, motor_alpha=motor_alpha)
    jo, jr = np.asarray(jo), np.asarray(jr)
    assert to.shape == (40, N) and tr.shape == (N,)
    # resets happened (progress restarted below the count of steps run)
    # and the reset flags agree
    assert (jo[19] < T).sum() >= 100
    np.testing.assert_array_equal(to[20].numpy(), jo[20])
    np.testing.assert_array_equal(to[19].numpy(), jo[19])
    np.testing.assert_allclose(to[0:29].numpy(), jo[0:29], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(to[29:].numpy(), st[29:])


def test_reset_draws_keep_state_in_distribution():
    """Full thrust for 200 steps: envs climb out of the box and reset
    many times; the state stays finite, unit-quaternion and in range."""
    st = make_state(1)
    out, rew = tfh.rollout_fused(torch.from_numpy(st),
                                 torch.tensor([0.0, 0.0, 0.0, 1.0]), 9, 200)
    root = out[0:13].numpy()
    assert np.isfinite(root).all() and np.isfinite(rew.numpy()).all()
    assert np.abs(root[0:3]).max() < 4.0
    np.testing.assert_allclose(np.linalg.norm(root[3:7], axis=0), 1.0,
                               atol=1e-3)


def test_checks_and_build_entry():
    st = torch.zeros((40, N))
    with pytest.raises(ValueError, match="action"):
        tfh.rollout_fused(st, torch.zeros(3), 0, 1)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tfh.rollout_fused(torch.zeros((40, 512)), torch.zeros(4), 0, 1)
    assert tfh.KERNEL.source.name == "fused_hovering.cu"
    assert tfh.KERNEL.source.exists()
    assert "fused_hovering_launch" in tfh.KERNEL.entry_points


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """csrc/fused_hovering.cu compiled with g++ against csrc/cuda_emu.h
    (one std::thread per CUDA thread, a warp's vote through a barrier of
    32), as a CudaKernel with the wrapper's entry points."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return build.build_emulated(
        tfh.KERNEL, tmp_path_factory.mktemp("emu") / "libfused_hovering_emu.so")


# the smoke test's climb (thrust 0.4) and the reference bench's hover
# (remap_actions([0, 0, 0, -0.7]): thrust 0.15), both remapped
ACTIONS = {"climb": [0.05, -0.05, 0.02, 0.4], "hover": [0.0, 0.0, 0.0, 0.15]}
# envs that leave the box upward within two steps, some alone in their
# warp (env 165 is lane 5 of warp 5)
LONE_EXITS = [133, 165, 230, 300, 517, 901]


@pytest.mark.parametrize("action", sorted(ACTIONS))
@pytest.mark.parametrize("motor_alpha", [0.0, 0.6])
def test_kernel_source_matches_plain_on_cpu(emulated_kernel, action,
                                            motor_alpha):
    """The kernel on the emulated card (8 blocks of 128 envs), 12 steps
    with time-outs (envs 0:64), whole warps leaving the box (64:128),
    lone envs leaving it in warps where no other env resets, and fresh
    resets and arbitrary previous actions in the input, against the plain
    version: state within 1e-4, reward sums within 1e-3, progress and
    reset rows equal, rows 29:40 bit for bit; two runs bitwise equal."""
    kernel = emulated_kernel
    st = make_state(3)
    st[2, LONE_EXITS], st[9, LONE_EXITS] = 1.99, 1.0
    packed = torch.from_numpy(st)
    act = torch.tensor(ACTIONS[action])
    seed = 13579
    before = kernel.launches["env"]
    runs = [tfh._kernel_rollout(kernel, packed, act, seed, T, motor_alpha)
            for _ in range(2)]
    assert kernel.launches["env"] == before + 2
    ref_out, ref_rew = tfh.rollout_fused_plain(packed, act, seed, T,
                                               motor_alpha=motor_alpha)
    out, rew = runs[0]
    # time-outs, exits and the lone exits all reset in the window
    fresh = ref_out[19] < T
    assert fresh[:128].all() and fresh[LONE_EXITS].all()
    assert torch.equal(out[19:21], ref_out[19:21])
    torch.testing.assert_close(out[:29], ref_out[:29], atol=1e-4, rtol=0)
    torch.testing.assert_close(rew, ref_rew, atol=1e-3, rtol=0)
    assert torch.equal(out[29:].view(torch.int32),
                       packed[29:].view(torch.int32))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_hovering_ab_traffic_bound_and_sass(monkeypatch):
    """kernels/hovering_ab.py's pieces that need no card: the two traffics
    (the bench's hover action remaps to thrust 0.15), the bound's count,
    and the step loop's SASS counts on a made-up listing: the loop is the
    widest backward branch, a skipped local-memory reduction and a
    slow-path call setup are cold, and the reset block lies behind the
    vote's forward branch."""
    from airgym_tpu_torch.kernels import hovering_ab as ha
    packed, acts = ha.traffic(torch.device("cpu"), N)
    assert packed.shape == (40, N) and (packed[19, :256] == 2380.0).all()
    np.testing.assert_array_equal(acts["hover"].numpy(),
                                  np.array([0, 0, 0, 0.15], np.float32))
    np.testing.assert_array_equal(acts["climb"].numpy(),
                                  np.array(ha.CLIMB, np.float32))
    ops, nbytes, _, by = ha.bound(N, 64, 10)
    assert ops == ha.STEP_OPS * N * 64 + ha.RESET_OPS * 10 + ha.LAUNCH_OPS * N
    assert nbytes == 4.0 * (2 * 29 * N + N + 4) and by == "operations"
    body = ["FFMA R0", "FCHK P0, R1, R2", "@!P0 BRA 0x70", "MOV R4, R5",
            "CALL.REL.NOINC 0x200", "FSETP.GT.AND P1, PT, R3, R4, PT",
            "@P1 BRA 0xc0", "STL [R1], R2", "LDL R3, [R1]", "FADD R3",
            "VOTE.ANY R6, PT, P2", "@!P3 BRA 0x110", "IMAD R7", "LOP3.LUT R8",
            "I2FP.F32.U32 R9", "@P4 BRA 0x20"]
    listing = [(0x0, "LDC R1"), (0x10, "S2R R0, SR_TID.X")] \
        + [(0x20 + 16 * i, t) for i, t in enumerate(body)] \
        + [(0x120, "STG.E [R2], R0"), (0x130, "EXIT")]
    fake = {"_Z11sass_probev": listing[:3],
            "_Z21fused_hovering_kernelPKfffffPfS1_iijffi": listing}
    monkeypatch.setattr(ha.build, "sass", lambda kernel: fake)
    sass = ha.loop_sass(None)
    assert sass == {"kernel": 20, "loop": 16, "hot": 11, "reset": 3,
                    "hot_reset": 3}
    # a quarter of the warp-steps ran the reset block
    c = [0, 0, 0, 0, N // 32 * 2 // 4, 0, 0]
    assert ha.per_step(sass, c, N, 2) == 11 - 0.75 * 3

"""The port's fused CNN encoder (experiments/fused_cnn.py and
CNNEncoder(impl='pallas')) against the JAX package's, on the CPU: the
weight folds, the plain forward and the parameter gradients against
``fused_cnn.encode_pooled(..., interpret=True)`` and
``CNNEncoder(impl='pallas_interpret')``, and the port's 'pallas' path
against its own 'auto' (cuDNN-stack) path; and the CUDA source itself,
compiled for the CPU against csrc/cuda_emu.h, against the plain version.

Tolerances: float32 as the JAX suite's own (tests/test_fused_cnn.py):
forward rtol 2e-4 / atol 2e-5, gradients rtol 5e-4 / atol 5e-4 *
max|ref|. bfloat16: both sides round at the same points, so they differ
only where a float32 sum taken in another order rounds to the other
neighbouring bf16 value: the forward within 1e-3 * max|ref| (one bf16 ulp
of an activation, averaged by the pool), each gradient element within 8e-3
of its own size (two bf16 ulps: dw0-dw2 are returned in bf16) plus 1e-3 *
max|ref| (a flipped rounding of g0 / g1 / g2 feeding a sum). The BN folds
agree within 5e-7: XLA's CPU rsqrt is not correctly rounded (1-2 ulp).
"""
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.experiments import fused_cnn as jfc
from airgym_tpu.models import actor_critic as jac
from airgym_tpu_torch.experiments import fused_cnn as tfc
from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.models import actor_critic as tac
from airgym_tpu_torch.rl import checkpoint as tckpt

SHAPES = [(3, 212, 120), (5, 28, 20)]      # 212 x 120: Planning's camera
SHAPE_IDS = ["212x120", "28x20"]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def random_ws(rng):
    """The 12 kernel inputs (float32 numpy), BN rows away from 1 / 0."""
    ws = {}
    for k in tfc.W_KEYS:
        if k in tfc.MAT:
            r, c = tfc.MAT[k]
            ws[k] = (rng.normal(size=(r, c)) / np.sqrt(r)).astype(np.float32)
        elif k[0] == "s":
            ws[k] = rng.uniform(0.5, 1.5, tfc.ROW[k]).astype(np.float32)
        else:
            ws[k] = rng.normal(0.0, 0.2, tfc.ROW[k]).astype(np.float32)
    return ws


def close(got, ref, dtype, what, grad=False):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    if dtype == "f32":
        rtol, atol = (5e-4, 5e-4 * scale) if grad else (2e-4, 2e-5)
    else:
        rtol, atol = (8e-3, 1e-3 * scale) if grad else (0.0, 1e-3 * scale)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_pooled_matches_jax(shape, dtype):
    """Plain forward and the autograd gradients of sum(pooled * probe)
    against the JAX custom_vjp in interpret mode; the image gets none."""
    tdt, jdt = DTYPES[dtype]
    b, h, w = shape
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    ws = random_ws(rng)
    probe = rng.normal(size=(b, 64)).astype(np.float32)

    xj = jnp.asarray(x).astype(jdt)
    wsj = {k: jnp.asarray(v) for k, v in ws.items()}
    out_j = jfc.encode_pooled(xj, wsj, interpret=True)
    g_j = jax.grad(lambda p: jnp.sum(
        jfc.encode_pooled(xj, p, interpret=True) * probe))(wsj)

    xt = torch.from_numpy(x).to(tdt).requires_grad_(dtype == "f32")
    wst = {k: torch.tensor(v, requires_grad=True) for k, v in ws.items()}
    before = dict(tfc.KERNEL.launches)
    out_t = tfc.encode_pooled(xt, wst)
    (out_t * torch.from_numpy(probe)).sum().backward()
    assert dict(tfc.KERNEL.launches) == before       # no kernel on the CPU
    assert out_t.dtype == torch.float32 and out_t.shape == (b, 64)
    close(out_t.detach(), out_j, dtype, "pooled")
    for k in tfc.W_KEYS:
        close(wst[k].grad, g_j[k], dtype, k, grad=True)
    if dtype == "f32":
        assert xt.grad is None


def test_autograd_function_returns_no_image_gradient():
    """The backward hands None to the image and each gradient in its
    input's dtype (bf16 matrices round there, as the JAX kernel's
    g.astype(ws[k].dtype))."""
    rng = np.random.default_rng(3)
    ws = random_ws(rng)
    x = torch.from_numpy(rng.normal(size=(2, 16, 8)).astype(np.float32)).to(
        torch.bfloat16)
    packed = [torch.tensor(ws[k]).to(torch.bfloat16 if k in tfc.MAT
                                     else torch.float32).requires_grad_()
              for k in tfc.W_KEYS]
    x.requires_grad_()
    out = tfc._EncodePooled.apply(x, *packed)
    out.sum().backward()
    assert x.grad is None
    for p in packed:
        assert p.grad.dtype == p.dtype
    flat = tfc.encode_pooled_plain_bwd(x.detach(), [p.detach() for p in
                                                    packed],
                                       torch.ones((2, 64)))
    for p, g in zip(packed, flat):
        assert torch.equal(p.grad, g.to(p.dtype))


def jax_cnn_params(seed=1, h=28, w=20):
    """A JAX CNN actor-critic's params with non-trivial batch norms."""
    jm = jac.ActorCritic(num_actions=4, image_encoder="cnn",
                         cnn_compute_dtype=None)
    full = jm.init(jax.random.PRNGKey(seed),
                   {"image": jnp.zeros((1, 1, h, w)),
                    "observation": jnp.zeros((1, 16))})
    p = jax.tree.map(np.asarray, full)
    rng = np.random.default_rng(seed + 1)
    for i, c in ((0, 16), (1, 32), (2, 64)):
        bn = p["params"]["actor_cnn"][f"bn{i}"]
        bn["mean"] = rng.normal(0, 0.3, c).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
    return p


def port_model(p, impl, dtype=None):
    m = tac.ActorCritic(16, 4, image_encoder="cnn", cnn_compute_dtype=dtype,
                        cnn_impl=impl)
    m.load_state_dict(tckpt.from_jax(p, None, None)["model"])
    return m


def test_folds_match_jax():
    """The folded matrices are bit-equal to _FoldedConv0 / _CellConv1's
    return_matrix outputs and conv2's HWIO reshape, with weights carried
    across through the checkpoint map."""
    p = jax_cnn_params()
    cnn = p["params"]["actor_cnn"]
    fw = port_model(p, "pallas").actor_cnn.fused_weights()
    w0, b0 = jac._FoldedConv0(features=16).apply(
        {"params": cnn["conv0"]}, None, return_matrix=True)
    w1, b1 = jac._CellConv1(features=32, in_features=16).apply(
        {"params": cnn["conv1"]}, None, return_matrix=True)
    want = {"w0": w0, "b0": b0, "w1": w1, "b1": b1,
            "w2": cnn["conv2"]["kernel"].reshape(288, 64),
            "b2": cnn["conv2"]["bias"]}
    for k, v in want.items():
        np.testing.assert_array_equal(fw[k].detach().numpy(), np.asarray(v),
                                      err_msg=k)
    for i, c in ((0, 16), (1, 32), (2, 64)):
        s, t = jac.FrozenBatchNorm(c).apply({"params": cnn[f"bn{i}"]})
        reps = 4 if i == 0 else 1
        np.testing.assert_allclose(fw[f"s{i}"].detach().numpy(),
                                   np.tile(np.asarray(s), reps), rtol=5e-7)
        np.testing.assert_allclose(fw[f"t{i}"].detach().numpy(),
                                   np.tile(np.asarray(t), reps), rtol=5e-7,
                                   atol=1e-7)


@pytest.mark.parametrize("hw", [(28, 20), (212, 120)], ids=["28x20",
                                                            "212x120"])
def test_encoder_pallas_matches_jax_pallas_interpret(hw):
    """CNNEncoder(impl='pallas') on the CPU against the JAX
    CNNEncoder(impl='pallas_interpret') in float32: features and the
    gradients of every CNN parameter through the folds; the frozen BN
    statistics get none."""
    h, w = hw
    p = jax_cnn_params(h=h, w=w)
    cnn = {"params": p["params"]["actor_cnn"]}
    rng = np.random.default_rng(4)
    img = rng.normal(size=(3, 1, h, w)).astype(np.float32)
    probe = rng.normal(size=(3, 30)).astype(np.float32)
    enc = jac.CNNEncoder(compute_dtype=None, impl="pallas_interpret")
    f_ref = enc.apply(cnn, jnp.asarray(img))
    g_ref = jax.grad(lambda q: jnp.sum(enc.apply(q, jnp.asarray(img))
                                       * probe))(cnn)["params"]
    m = port_model(p, "pallas").actor_cnn
    f = m(torch.from_numpy(img))
    (f * torch.from_numpy(probe)).sum().backward()
    close(f.detach(), f_ref, "f32", "features")
    grads = {k: v.grad for k, v in m.named_parameters()}
    for i, (ci, bi) in enumerate(((0, 2), (3, 5), (6, 8))):
        conv, bn = g_ref[f"conv{i}"], g_ref[f"bn{i}"]
        close(grads[f"features.{ci}.weight"],
              np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)), "f32",
              f"conv{i}.kernel", grad=True)
        close(grads[f"features.{ci}.bias"], conv["bias"], "f32",
              f"conv{i}.bias", grad=True)
        close(grads[f"features.{bi}.weight"], bn["scale"], "f32",
              f"bn{i}.scale", grad=True)
        close(grads[f"features.{bi}.bias"], bn["bias"], "f32", f"bn{i}.bias",
              grad=True)
        assert float(jnp.abs(bn["mean"]).max()) == 0.0
        assert not m.features[bi].running_mean.requires_grad
        assert not m.features[bi].running_var.requires_grad
    close(grads["fc.weight"], np.asarray(g_ref["fc"]["kernel"]).T, "f32",
          "fc.kernel", grad=True)


def test_pallas_matches_auto_in_f32():
    """The fused path and the cuDNN-stack path of the port: the same
    parameters (state_dict keys), features within 1e-4, and gradients of
    the conv weights within 1e-4 * max|ref| (float32: other sum orders)."""
    torch.manual_seed(0)
    a = tac.CNNEncoder(compute_dtype=None, impl="auto",
                       generator=torch.Generator().manual_seed(5))
    b = tac.CNNEncoder(compute_dtype=None, impl="pallas")
    b.load_state_dict(a.state_dict())
    assert list(a.state_dict()) == list(b.state_dict())
    for bn in (a.features[2], a.features[5], a.features[8]):
        with torch.no_grad():
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.2)
    b.load_state_dict(a.state_dict())
    img = torch.randn((4, 1, 40, 24), generator=torch.Generator()
                      .manual_seed(6))
    fa, fb = a(img), b(img)
    torch.testing.assert_close(fb, fa, atol=1e-4, rtol=0)
    fa.square().sum().backward()
    fb.square().sum().backward()
    for (k, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        scale = float(pa.grad.abs().max())
        assert float((pa.grad - pb.grad).abs().max()) <= 1e-4 * scale, k


def test_impl_option_errors():
    img = torch.zeros((2, 1, 30, 20))
    with pytest.raises(ValueError, match="divisible by 4"):
        tac.CNNEncoder(impl="pallas")(img)
    with pytest.raises(ValueError, match="'pallas'"):
        tac.CNNEncoder(impl="pallas_interpret")
    with pytest.raises(ValueError, match="impl must be"):
        tac.CNNEncoder(impl="triton")
    with pytest.raises(ValueError, match="divisible by 4"):
        tfc.encode_pooled(torch.zeros((2, 30, 20, 1)),
                          {k: torch.zeros(tfc.MAT.get(k, (tfc.ROW.get(k),)))
                           for k in tfc.W_KEYS})
    # 'auto' still takes any even or odd size
    assert tac.CNNEncoder(impl="auto")(img).shape == (2, 30)


def test_trainer_passes_cnn_impl():
    """network_kw={'cnn_impl': 'pallas'} reaches the model the PPO trainer
    builds, as in the JAX package (rl/ppo.py's make_model)."""
    import airgym_tpu_torch.envs as tenvs
    from airgym_tpu_torch.rl import ppo as tppo
    task = tenvs.make_task("planning", num_envs=2, device="cpu",
                           cam_width=16, cam_height=8)
    tr = tppo.PPO(task, tppo.PPOConfig(horizon=8, minibatch_size=8,
                                       mini_epochs=1),
                  network_kw={"cnn_impl": "pallas"})
    assert tr.make_model().actor_cnn.impl == "pallas"
    assert tppo.PPO(task, tppo.PPOConfig(horizon=8, minibatch_size=8,
                                         mini_epochs=1)
                    ).make_model().actor_cnn.impl == "auto"


@pytest.fixture(scope="module")
def emulated_kernels(tmp_path_factory):
    """csrc/fused_cnn.cu compiled with g++ against csrc/cuda_emu.h (one
    std::thread per CUDA thread), bound with the wrapper's signatures."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return build.build_emulated(
        tfc.KERNEL, tmp_path_factory.mktemp("emu") / "libfused_cnn_emu.so"
    ).lib()


@pytest.mark.parametrize("dtype,shape", [("f32", (3, 28, 20)),
                                         ("bf16", (3, 28, 20)),
                                         ("bf16", (2, 212, 120))],
                         ids=["f32-28x20", "bf16-28x20", "bf16-212x120"])
def test_kernel_source_matches_plain_on_cpu(emulated_kernels, dtype, shape):
    """The forward, backward and reduction kernels of csrc/fused_cnn.cu,
    run on the CPU through the emulation header, against the plain
    versions, at chip_smoke.py's tolerances (features 2e-5 / 1e-3 and
    gradients 2e-4 / 1e-2 of max|ref| in float32 / bf16). bf16 runs the
    tensor-core forward and backward (mma.sync emulated), float32 the
    scalar ones. B = 3 on the emulated two-SM card makes a forward block
    walk two images (in bf16 reusing its a1 workspace)."""
    lib, tdt = emulated_kernels, DTYPES[dtype][0]
    b, h, w = shape
    rng = np.random.default_rng(21)
    ws_np = random_ws(rng)
    x = torch.from_numpy(rng.normal(size=(b, h, w)).astype(np.float32)).to(
        tdt)
    ws = [torch.from_numpy(ws_np[k]).to(tdt if k in tfc.MAT
                                        else torch.float32)
          for k in tfc.W_KEYS]
    dp = torch.from_numpy(rng.normal(size=(b, 64)).astype(np.float32))
    k = dict(zip(tfc.W_KEYS, ws))
    mats = [k[key].contiguous() for key in tfc.MAT_KEYS]
    rows = torch.cat([k[key] for key in tfc.ROW_KEYS])
    is_bf16 = int(tdt == torch.bfloat16)
    assert lib.fused_cnn_smem_bytes(h, w) > 0

    out = torch.empty((b, 64))
    fwd_blocks = lib.fused_cnn_fwd_blocks(b)
    assert fwd_blocks == min(b, 2)                      # the emulated SMs
    fwd_work = torch.empty(fwd_blocks * lib.fused_cnn_fwd_workspace_bytes(
        h, w, is_bf16), dtype=torch.uint8)
    assert fwd_work.numel() == (fwd_blocks * (h // 4) * (w // 4) * 32 * 2
                                if is_bf16 else 0)
    assert lib.fused_cnn_fwd_launch(
        x.data_ptr(), *[m.data_ptr() for m in mats], rows.data_ptr(),
        fwd_work.data_ptr(), out.data_ptr(), b, h, w, is_bf16, None) == 0
    blocks = lib.fused_cnn_bwd_blocks(b)
    work = torch.empty(blocks * lib.fused_cnn_workspace_floats(h, w, is_bf16))
    part = torch.empty((blocks, tfc.N_PARAM))
    flat = torch.empty(tfc.N_PARAM)
    assert lib.fused_cnn_bwd_launch(
        x.data_ptr(), dp.data_ptr(), *[m.data_ptr() for m in mats],
        rows.data_ptr(), work.data_ptr(), part.data_ptr(), flat.data_ptr(),
        b, h, w, is_bf16, None) == 0

    f32 = dtype == "f32"
    ref = tfc.encode_pooled_plain(x, ws)
    assert float((out - ref).abs().max()) <= (2e-5 if f32 else 1e-3) * \
        float(ref.abs().max())
    for key, got, want in zip(tfc.W_KEYS, tfc.unflatten_grads(flat),
                              tfc.encode_pooled_plain_bwd(x, ws, dp)):
        tol = (2e-4 if f32 else 1e-2) * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_mma_16816_matches_float64(emulated_kernels, seed):
    """mma_bf16.cuh's m16n8k16 product through the emulation header (its
    fragments swapped between the 32 emulated lanes of one warp): d = c +
    a @ b for random bf16 tiles equals the float64 product rounded once to
    float32, element for element."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32)).to(
        torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).to(
        torch.bfloat16)                                  # [n][k]
    c = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    d = torch.full((16, 8), float("nan"))
    assert emulated_kernels.fused_cnn_mma_probe(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), None) == 0
    ref = c.double() + a.double() @ b.double().T
    assert torch.equal(d, ref.float())

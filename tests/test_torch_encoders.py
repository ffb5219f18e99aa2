"""The port's ResNet-18 and VAE encoders (models/resnet.py,
models/vae.py) against the JAX package's: the modules at batch 2 on
212 x 120 frames, both bilinear resizes against ``jax.image.resize``,
the two importers fed one seeded state dict each, the actor-critic with
each encoder through ``checkpoint.from_jax``, the runner's graft of a
written ``vae_model.pth`` and of a torchvision-layout resnet18 file
beside the JAX runner's, and a Planning epoch with each encoder that
leaves the frozen parameters bitwise unchanged.

The JAX side runs at matmul precision 'highest' (tests/conftest.py).
Tolerances, float32 with other summation orders: the resizes atol 1e-5
(3.6e-6 measured at 212 x 120); module outputs within 1e-4 * max|ref| +
1e-5 (ResNet-18 is 18 layers deep); policy outputs atol 1e-5."""
import importlib.util
import math
import pathlib
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.models import actor_critic as jac
from airgym_tpu.models import resnet as jresnet
from airgym_tpu.models import vae as jvae
from airgym_tpu.rl import runner as jrunner
from airgym_tpu.rl.running_stats import RunningMeanStd as JaxRMS
import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch.models import actor_critic as tac
from airgym_tpu_torch.models import resnet as tresnet
from airgym_tpu_torch.models import vae as tvae
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import runner as trunner
from airgym_tpu_torch.rl.running_stats import RunningMeanStd
from test_resnet import _torch_resnet18

REPO = pathlib.Path(__file__).resolve().parents[1]
host = lambda tree: jax.tree.map(np.asarray, tree)


def close(got, ref, rel=1e-4, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err < rel * np.abs(ref).max() + atol, err


def frames(b=2, w=212, h=120, seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (b, 1, w, h)).astype(np.float32)


def train_vae_module():
    spec = importlib.util.spec_from_file_location(
        "train_vae", REPO / "scripts" / "train_vae.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_vae(latent=64, seed=7):
    return jax.jit(jvae.VAE(latent_dim=latent).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 1, 212, 120)),
        jax.random.PRNGKey(0))


def jax_resnet(output_dim=30, seed=3, params=None):
    """A JAX ResNet18Encoder's params (or ``params``, a host copy of
    one's) with non-trivial batch norms."""
    if params is None:
        params = host(jax.jit(jresnet.ResNet18Encoder(output_dim).init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 1, 32, 16))))
    rng = np.random.default_rng(seed)

    def bns(tree):
        for k, v in tree.items():
            if isinstance(v, dict) and "scale" in v and "var" in v:
                c = v["scale"].shape[0]
                v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                v["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                v["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(v, dict):
                bns(v)
    bns(params["params"])
    return params


# ---------------------------------------------------------------- resizes


@pytest.mark.parametrize("shape", [(212, 120), (208, 112)],
                         ids=["input_212x120", "decoder_208x112"])
def test_resize_matches_jax_image_resize(shape):
    """Both resizes shrink one axis, where jax.image.resize antialiases;
    torch F.interpolate without antialias differs by up to ~0.4."""
    x = frames(2, *shape, seed=1)
    ref = jax.image.resize(jnp.asarray(x), (2, 1) + tvae.IMAGE_RES,
                           method="bilinear")
    got = tvae.resize_bilinear(torch.from_numpy(x), tvae.IMAGE_RES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=tvae.IMAGE_RES, mode="bilinear",
        align_corners=False)
    assert np.abs(plain.numpy() - np.asarray(ref)).max() > 1e-2


def test_center_crop_negative_offset():
    """The second skip's crop: width 6 -> 7 takes column 5 alone (a
    negative offset under torch slice semantics), as the JAX crop."""
    x = np.arange(2 * 3 * 4 * 6, dtype=np.float32).reshape(2, 3, 4, 6)
    got = tvae._center_crop_torch(torch.from_numpy(x), 4, 7)
    ref = jvae._center_crop_torch(jnp.asarray(x.transpose(0, 2, 3, 1)), 4, 7)
    assert got.shape == (2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).transpose(0, 3, 1, 2))


# ---------------------------------------------------------------- modules


def test_resnet18_matches_jax():
    params = jax_resnet()
    ref = jax.jit(jresnet.ResNet18Encoder(30).apply)(
        params, jnp.asarray(frames()))
    sd = {}
    tckpt._jax_resnet_to_ref(params["params"], sd)
    enc = tresnet.ResNet18Encoder(30)
    enc.load_state_dict(sd)
    with torch.no_grad():
        close(enc(torch.from_numpy(frames())), ref)
    # only fc trains
    assert [k for k, p in enc.named_parameters() if p.requires_grad] == [
        "fc.weight", "fc.bias"]


def test_vae_matches_jax(tmp_path):
    """Encoder, decoder and vae_loss; the weights travel through the JAX
    exporter's vae_model.pth, keys prefixed 'module.' / 'dronet.' for
    clean_state_dict."""
    params = jax_vae()
    path = str(tmp_path / "vae_model.pth")
    train_vae_module().export_vae_pth(params, path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = {("module." + k.replace("encoder.", "dronet.", 1)
           if k.startswith("encoder.") else k): v for k, v in raw.items()}
    model = tvae.VAE(64)
    model.load_state_dict(tvae.import_torch_state_dict(sd))

    x = frames(seed=2)
    recon_j, mean_j, logvar_j, z_j = jax.jit(jvae.VAE(64).apply)(
        params, jnp.asarray(x))
    with torch.no_grad():
        recon_t, mean_t, logvar_t, z_t = model(torch.from_numpy(x))
    close(mean_t, mean_j)
    close(logvar_t, logvar_j)
    close(recon_t, np.asarray(recon_j).transpose(0, 3, 1, 2))
    target = np.array(jvae._to_image_res(jnp.asarray(x)))
    loss_j, parts_j = jvae.vae_loss(recon_j, jnp.asarray(
        target.transpose(0, 2, 3, 1)), mean_j, logvar_j)
    loss_t, parts_t = tvae.vae_loss(recon_t, torch.from_numpy(target),
                                    mean_t, logvar_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(float(parts_t["kl"]), float(parts_j["kl"]),
                               rtol=1e-4)
    # the frozen RL encoder returns the means
    enc = tvae.VAEEncoder(64)
    enc.encoder.load_state_dict(model.encoder.state_dict())
    close(enc(torch.from_numpy(x)), mean_j)
    assert not any(p.requires_grad for p in enc.parameters())


def test_importers_on_one_seeded_state_dict():
    """One seeded torch state dict per importer, fed to each side: the
    VAE's (random tensors in vae_model.pth's layout) and a torchvision
    resnet18 with randomised batch norms."""
    rng = np.random.default_rng(11)
    ref_vae = tvae.VAE(16)
    sd = {k: torch.from_numpy(rng.normal(0, 0.05, v.shape).astype(
        np.float32)) for k, v in ref_vae.state_dict().items()}
    jp = jvae.import_torch_state_dict(sd, latent_dim=16)
    model = tvae.VAE(16)
    model.load_state_dict(tvae.import_torch_state_dict(sd))
    x = frames(1, seed=4)
    _, mean_j, logvar_j, _ = jax.jit(jvae.VAE(16).apply)(jp,
                                                          jnp.asarray(x))
    with torch.no_grad():
        _, mean_t, logvar_t, _ = model(torch.from_numpy(x))
    close(mean_t, mean_j)
    close(logvar_t, logvar_j)

    net = _torch_resnet18()
    jp = jresnet.import_torchvision_state_dict(net.state_dict(), 30)
    tsd = tresnet.import_torchvision_state_dict(
        net.state_dict(), 30, generator=torch.Generator().manual_seed(0))
    enc = tresnet.ResNet18Encoder(30)
    enc.load_state_dict(tsd)
    want = {}
    tckpt._jax_resnet_to_ref(jp["params"], want)
    for k, v in want.items():
        if not k.startswith("fc.") and "num_batches" not in k:
            np.testing.assert_array_equal(tsd[k].numpy(), v.numpy(), k)
    gray = frames(2, 64, 48, seed=3)
    with torch.no_grad():
        feats = net.backbone(torch.from_numpy(np.repeat(gray, 3, 1)))
        close(enc.backbone(torch.from_numpy(gray)), feats.numpy())


@pytest.mark.parametrize("encoder", ["vae", "resnet"])
def test_actor_critic_with_encoder_matches_jax(encoder):
    """ActorCritic with each encoder, its weights carried by from_jax
    (actor_enc / actor_resnet); features and policy outputs."""
    kw = ({"image_encoder": "vae", "vae_latent_dim": 16} if encoder == "vae"
          else {"image_encoder": "resnet", "image_feature_dim": 12})
    feat = 16 if encoder == "vae" else 12
    jm = jac.ActorCritic(num_actions=4, **kw)
    sample = {"image": jnp.zeros((1, 1, 32, 16)),
              "observation": jnp.zeros((1, 16))}
    params = host(jax.jit(jm.init)(jax.random.PRNGKey(2), sample))
    if encoder == "resnet":
        params["params"]["actor_resnet"] = jax_resnet(
            params={"params": params["params"]["actor_resnet"]})["params"]
    tm = tac.ActorCritic(16, 4, **kw)
    tm.load_state_dict(tckpt.from_jax(params, None, None)["model"])
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 3, (5, 1, 32, 16)).astype(np.float32)
    vec = rng.normal(0, 1, (5, 16)).astype(np.float32)
    s_img = rng.uniform(0, 3, (32, 1, 32, 16)).astype(np.float32)
    s_vec = rng.normal(0.3, 2, (32, 16 + feat)).astype(np.float32)
    j_rms = {"image": JaxRMS.create((1, 32, 16)).update(jnp.asarray(s_img)),
             "observation": JaxRMS.create((16 + feat,)).update(
                 jnp.asarray(s_vec))}
    t_rms = {"image": RunningMeanStd.create((1, 32, 16)).update(
                 torch.from_numpy(s_img)),
             "observation": RunningMeanStd.create((16 + feat,)).update(
                 torch.from_numpy(s_vec))}
    params = jax.tree.map(jnp.asarray, params)
    mu_j, sig_j, v_j = jax.jit(jm.apply)(
        params, {"image": jnp.asarray(img), "observation": jnp.asarray(vec)},
        j_rms)
    with torch.no_grad():
        mu_t, sig_t, v_t = tm({"image": torch.from_numpy(img),
                               "observation": torch.from_numpy(vec)}, t_rms)
    for got, ref in ((mu_t, mu_j), (sig_t, sig_j), (v_t, v_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------- runner


class JaxTS(NamedTuple):
    params: Any


def grafting_pair(block):
    """The JAX runner's graft and the port runner's, each into a fresh
    planning model: on the JAX side the parameter subtree the graft
    writes (the VAE's encoder) or keeps (the ResNet's fc), on the port's
    a planning trainer's fresh state."""
    cfg = {"network": {"mlp": {"units": [32], "activation": "elu"},
                       **block}, "config": {}}
    fc = {"kernel": np.ones((512, 16), np.float32),
          "bias": np.zeros((16,), np.float32)}
    tree = ({"actor_enc": {"vae": {}}} if "vae" in block
            else {"actor_resnet": {"fc": fc}})
    ts_j = jrunner.Runner().load({"params": cfg})._maybe_load_pretrained_vae(
        JaxTS({"params": tree}))
    t_tr = tppo.PPO(tenvs.make_task("planning", num_envs=4, device="cpu",
                                    **TASK_KW),
                    tppo.PPOConfig(horizon=4, minibatch_size=8),
                    network_kw=trunner.network_kw_from_params(cfg))
    ts_t = t_tr.init(0)
    before = {k: v.clone() for k, v in ts_t.model.state_dict().items()}
    ts_t2 = trunner.Runner().load(
        {"params": cfg})._maybe_load_pretrained_vae(ts_t)
    return ts_j, ts_t2, before


TASK_KW = dict(num_trees=6, cam_width=32, cam_height=16)


def test_runner_grafts_pretrained_vae(tmp_path):
    """A vae: block with model_folder / model_file: the port grafts the
    file's encoder as the JAX runner does; the rest of the model stays."""
    train_vae_module().export_vae_pth(jax_vae(), str(tmp_path / "vae.pth"))
    block = {"vae": {"latent_dims": 64, "model_folder": str(tmp_path),
                     "model_file": "vae.pth"}}
    ts_j, ts_t, before = grafting_pair(block)
    enc_j = ts_j.params["params"]["actor_enc"]["vae"]["encoder"]
    want = {}
    tckpt._jax_vae_encoder_to_ref(host(enc_j), want)
    got = ts_t.model.actor_enc.encoder.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    assert not torch.equal(before["actor_enc.encoder.conv0.weight"],
                           got["conv0.weight"])
    for k, v in ts_t.model.state_dict().items():
        if not k.startswith("actor_enc."):
            assert torch.equal(v, before[k]), k


def test_runner_grafts_pretrained_resnet(tmp_path):
    """A resnet: block with a torchvision resnet18 file: conv1 summed over
    RGB, the backbone grafted, the model's own fc kept."""
    net = _torch_resnet18()
    torch.save(net.state_dict(), str(tmp_path / "resnet18.pth"))
    block = {"resnet": {"type": "resnet18", "output_dim": 16,
                        "model_folder": str(tmp_path),
                        "model_file": "resnet18.pth"}}
    ts_j, ts_t, before = grafting_pair(block)
    want = {}
    tckpt._jax_resnet_to_ref(host(ts_j.params["params"]["actor_resnet"]),
                             want)
    np.testing.assert_array_equal(           # the JAX graft kept its fc
        np.asarray(ts_j.params["params"]["actor_resnet"]["fc"]["kernel"]),
        1.0)
    got = ts_t.model.actor_resnet.state_dict()
    for k, v in want.items():
        if not k.startswith("fc.") and "num_batches" not in k:
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    np.testing.assert_array_equal(
        got["conv1.weight"].numpy(),
        net.state_dict()["conv1.weight"].numpy().sum(1, keepdims=True))
    for k in ("fc.weight", "fc.bias"):
        assert torch.equal(got[k], before[f"actor_resnet.{k}"])


def test_no_encoder_block_is_a_noop():
    runner = trunner.Runner().load({"params": {"network": {}, "config": {}}})
    tr = tppo.PPO(tenvs.make_task("hovering", num_envs=4, device="cpu"),
                  tppo.PPOConfig(horizon=4, minibatch_size=8))
    ts = tr.init(0)
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    assert runner._maybe_load_pretrained_vae(ts) is ts
    for k, v in ts.model.state_dict().items():
        assert torch.equal(v, before[k])


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("encoder", ["vae", "resnet"])
def test_planning_epoch_leaves_frozen_parts_unchanged(encoder):
    """One plain-trainer Planning epoch at tiny width with each encoder:
    the frozen VAE encoder and ResNet backbone bitwise unchanged, out of
    Adam's state; the trained parts (the MLP, the ResNet's fc) moved; the
    'observation' stats span [obs ++ the encoder's features]."""
    kw = ({"image_encoder": "vae", "vae_latent_dim": 8} if encoder == "vae"
          else {"image_encoder": "resnet", "image_feature_dim": 6})
    task = tenvs.make_task("planning", num_envs=4, device="cpu", **TASK_KW)
    tr = tppo.PPO(task, tppo.PPOConfig(horizon=8, minibatch_size=16,
                                       mini_epochs=2), network_kw=kw)
    ts = tr.init(1)
    assert tr.frame_dedup
    assert ts.obs_rms["observation"].mean.shape == (16 + (
        8 if encoder == "vae" else 6),)
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    frozen = {k for k, p in ts.model.named_parameters()
              if not p.requires_grad}
    assert frozen and frozen.isdisjoint(ts.adam["m"])
    ts2, m = tr.train_epoch(ts)
    assert math.isfinite(float(m["loss"]))
    after = ts2.model.state_dict()
    for k in before:
        moved = not torch.equal(after[k], before[k])
        trains = k in ts2.adam["m"]
        assert moved == trains or "running" in k or "num_batches" in k, k
    assert float(ts2.adam["count"][0]) == 2 * 2
    if encoder == "resnet":
        assert "actor_resnet.fc.weight" in ts2.adam["m"]
    # the native checkpoint carries the encoders, so a resume is exact
    back = tckpt.restore(tr.init(2), tckpt.payload(ts2))
    for k, v in back.model.state_dict().items():
        assert torch.equal(v, after[k]), k

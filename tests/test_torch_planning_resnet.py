"""Planning with the frozen ResNet-18 depth encoder (the benchmark's
``planning_resnet`` configuration) against the benchmark's plain
reference (``portbench/reference/plain/models/resnet.py``) on the CPU:
the encoder on the same seeded weights with randomised frozen batch
norms, the models one seed builds, a tiny run of the
``planning_resnet.train`` cell judged under its limits with the backbone
left as it was (and a planted fault failing them), the encoder's count
against its own convolutions, and a reference that loads no JAX."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch import nn

from airgym_tpu_torch.models import actor_critic as ac
from airgym_tpu_torch.models.resnet import ResNet18Encoder
from portbench import harness
from portbench.counts.encoders import resnet as count
from portbench.reference import train as ref_train
from portbench.reference.plain.models import resnet as ref_resnet
from portbench.tests import _tiny

ROOT = Path(__file__).resolve().parents[1]
CELL = "planning_resnet.train"
CPU = torch.device("cpu")


def _encoders(seed):
    """The port's encoder and the reference's, each drawn from ``seed``,
    the reference's batch norms then given the port's randomised
    statistics and affine."""
    port = ResNet18Encoder(30, generator=torch.Generator().manual_seed(seed))
    ref = ref_resnet.ResNet18(30, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, ac.FrozenBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(torch.randn(c, generator=gen))
                m.running_mean.copy_(torch.randn(c, generator=gen))
                m.running_var.copy_(0.1 + torch.rand(c, generator=gen))
    missing = ref.load_state_dict(port.state_dict())
    assert not missing.missing_keys and not missing.unexpected_keys
    return port, ref


@pytest.mark.parametrize("w,h", [(64, 48), (212, 120)])
def test_encoder_equals_the_reference_on_randomised_batch_norms(w, h):
    """The same operations in the same order on the same weights: equal
    to the bit on the CPU (the folds, the residual adds, the pool)."""
    port, ref = _encoders(11)
    x = torch.randn(3, 1, w, h, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert got.shape == (3, 30)
    assert torch.equal(got, want)
    # a folding fault shows: the statistics move the features
    with torch.no_grad():
        ref.bn1.running_mean.zero_()
        assert not torch.allclose(ref(x), want, rtol=1e-3, atol=1e-3)


def _params(env_kw=None, **config):
    w = harness.cell(CELL)
    params = w["config_file"]["params"]
    params["config"].update(config)
    params["config"]["env_config"].update(env_kw or {})
    return w, params


def test_one_seed_builds_equal_models():
    from airgym_tpu_torch.rl import runner as runner_mod
    _, params = _params(num_actors=4)
    runner = runner_mod.Runner().load({"params": params})
    _, trainer, _ = runner.build({"seed": 5, "device": "cpu"})
    port = trainer.init(5).model
    ref = ref_train.build(params, CPU).init(5).model
    assert port.image_encoder == "resnet"
    a, b = port.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    frozen = {k for k, p in ref.named_parameters() if not p.requires_grad}
    assert frozen == {k for k, p in port.named_parameters()
                      if not p.requires_grad}
    assert frozen and all(k.startswith("actor_resnet.")
                          and not k.startswith("actor_resnet.fc.")
                          for k in frozen)


def test_tiny_cell_is_correct_and_leaves_the_backbone(monkeypatch):
    """The cell at 8 envs, horizon 8, minibatch 32 and 2 mini-epochs (the
    camera at its 212 x 120): its numbers pass the cell's limits, and in
    every snapshot (the program's epoch, the reference's and its replay)
    the backbone is as it was and the fc has moved."""
    w, _ = _params(**_tiny.SIZES["planning.train"])
    snaps = []
    snapshot = ref_train.snapshot

    def kept(*a, **k):
        out = snapshot(*a, **k)
        snaps.append(out[1])
        return out
    monkeypatch.setattr(ref_train, "snapshot", kept)
    res = _tiny.run(CELL, w=w)
    ok, checks = harness.judge(res["numbers"], w["limits"])
    assert ok, checks
    assert len(snaps) == 3
    for snap in snaps:
        backbone = [k for k in snap.p0 if k.startswith("actor_resnet.")
                    and not k.startswith("actor_resnet.fc.")]
        assert len(backbone) == 60
        for k in backbone:
            assert torch.equal(snap.p0[k], snap.p1[k]), k
            assert torch.equal(snap.p0[k], snap.p_end[k]), k
        assert not torch.equal(snap.p0["actor_resnet.fc.weight"],
                               snap.p1["actor_resnet.fc.weight"])


def test_update_keeping_the_backbone_equals_the_reference_to_the_bit():
    """One update at the tiny cell's sizes (8 envs, horizon 8, minibatch
    32, 2 mini-epochs), the port's on its own first rollout and the plain
    reference's replayed on it: the same dataset, and after the update
    the same parameters, Adam moments, step count, lr and metrics, to the
    bit. The port runs the backbone once per window and the ``fc`` alone
    in the later mini-epoch (``encode_hit``); the reference re-encodes in
    every minibatch."""
    from airgym_tpu_torch.rl import profiling
    from airgym_tpu_torch.rl import runner as runner_mod
    _, params = _params(**_tiny.SIZES["planning.train"])
    runner = runner_mod.Runner().load({"params": params})
    _, port, _ = runner.build({"seed": 5, "device": "cpu"})
    ref = ref_train.build(params, CPU)
    got = {}
    for name, tr in (("port", port), ("ref", ref)):
        def kept(ts, dataset, _name=name, _update=tr.update):
            got[_name] = (dataset,) + _update(ts, dataset)
            return got[_name][1:]
        tr.update = kept
    profiling.start()
    try:
        snap = ref_train.snapshot(port, port.init(5), 1)[1]
    finally:
        rec = profiling.stop()
    ref_train.replay(params, 5, CPU, snap.rollout, snap.last_value,
                     start=(ref, ref.init(5)))
    assert [r.name for r in rec].count("encode_hit") == \
        port.num_minibatches * (port.cfg.mini_epochs - 1) == 2

    def equal(a, b, at):
        if isinstance(a, dict):
            assert set(a) == set(b), at
            for k in a:
                equal(a[k], b[k], f"{at}.{k}")
        else:
            assert torch.equal(a, b), at
    (d_p, ts_p, m_p), (d_r, ts_r, m_r) = got["port"], got["ref"]
    equal(d_p, d_r, "dataset")
    equal(dict(ts_p.model.named_parameters()),
          dict(ts_r.model.named_parameters()), "params")
    equal(ts_p.adam, ts_r.adam, "adam")
    equal(ts_p.lr, ts_r.lr, "lr")
    equal(m_p, m_r, "metrics")


def test_tiny_cell_with_half_batch_is_not_correct(monkeypatch):
    """Each minibatch's loss over its first half alone, planted in the
    program: the cell's limits fail it."""
    from airgym_tpu_torch.rl import ppo
    init = ppo.PPO.__init__

    def planted(self, *a, **k):
        init(self, *a, **k)
        ref_train.plant_half_batch(self)
    monkeypatch.setattr(ppo.PPO, "__init__", planted)
    w, _ = _params(**_tiny.SIZES["planning.train"])
    ok, checks = harness.judge(_tiny.run(CELL, w=w)["numbers"],
                               w["limits"])
    assert not ok, checks


def test_count_equals_the_modules_own_convolutions():
    """MACs at 212 x 120 from the layer shapes against hooks on the
    module's own convolutions and fc; a call with gradients adds the
    fc's backward alone."""
    enc = ResNet18Encoder(30, generator=torch.Generator().manual_seed(0))
    convs, fcs = [], []

    def conv_hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        convs.append(out[0].numel() * m.in_channels // m.groups * k)

    for m in enc.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(conv_hook)
    enc.fc.register_forward_hook(
        lambda m, inp, out: fcs.append(m.in_features * m.out_features))
    with torch.no_grad():
        enc(torch.zeros(1, 1, 212, 120))
    assert len(convs) == 20
    assert count.conv_macs(212, 120) == sum(convs) == 936_498_688
    assert count.fc_macs() == sum(fcs)
    images = 7
    assert count.forward_flops(212, 120, images) == \
        2.0 * (sum(convs) + sum(fcs)) * images
    assert count.train_flops(212, 120, images) == \
        count.forward_flops(212, 120, images) + 2.0 * 2.0 * sum(fcs) * images
    assert count.nbytes(212, 120, images) == 4.0 * images * 212 * 120


def test_reference_loads_no_jax():
    code = ("import sys, torch\n"
            "sys.path.insert(0, '.')\n"
            "from portbench.reference.plain.models import resnet\n"
            "resnet.build({'type': 'resnet18', 'output_dim': 30}, "
            "torch.Generator().manual_seed(0))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'airgym_tpu', 'airgym_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

"""The port's host-side C++ PX4 cascade (airgym_tpu_torch/control/native.py)
against the port's ``px4.run`` and the JAX package's, in every mode: the
same numpy states and actions (N = 32, 5 steps), commands and all five
state fields within 2e-4 (the JAX suite's tolerance for its own native
cascade). The JAX package's native module is never loaded: its build
writes beside its source. The library builds with g++ under build/."""
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.control import px4 as jpx4
from airgym_tpu_torch.control import native
from airgym_tpu_torch.control import px4 as tpx4

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")

REPO = Path(__file__).resolve().parents[1]
N = 32
DT = 0.01
ATOL = 2e-4
MODES = ["prop", "rate", "atti", "vel", "pos"]


def random_states(rng):
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.uniform(-2, 2, (N, 3)), q,
                           rng.uniform(-3, 3, (N, 3)),
                           rng.uniform(-3, 3, (N, 3))], 1).astype(np.float32)


def random_actions(rng, mode):
    a = rng.uniform(-1, 1, (N, tpx4.num_actions(mode))).astype(np.float32)
    if mode in ("rate", "atti", "prop"):
        a[:, -1] = np.abs(a[:, -1])
    return a


def assert_states_close(native_cs, port_cs, jax_cs):
    for name in tpx4.CascadeState._fields:
        a = getattr(native_cs, name).numpy()
        np.testing.assert_allclose(a, getattr(port_cs, name).numpy(),
                                   atol=ATOL, err_msg=f"port {name}")
        np.testing.assert_allclose(a, np.asarray(getattr(jax_cs, name)),
                                   atol=ATOL, err_msg=f"jax {name}")


@pytest.mark.parametrize("mode", MODES)
def test_native_matches_port_and_jax(mode):
    rng = np.random.default_rng(MODES.index(mode))
    ctl = native.ParallelControl(mode, N)
    g, jg = tpx4.CascadeGains(), jpx4.CascadeGains()
    cs, jcs = tpx4.init_state(N), jpx4.init_state(N)
    for step in range(5):
        root, act = random_states(rng), random_actions(rng, mode)
        cmds_t, cs = tpx4.run(mode, g, cs, torch.from_numpy(root),
                              torch.from_numpy(act), DT)
        cmds_j, jcs = jpx4.run(mode, jg, jcs, jnp.asarray(root),
                               jnp.asarray(act), DT)
        # numpy on the first step, CPU tensors after it
        cmds_n = ctl.update(*((root, act) if step == 0 else
                              (torch.from_numpy(root),
                               torch.from_numpy(act))), dt=DT)
        assert cmds_n.shape == (N, 4) and cmds_n.dtype == np.float32
        np.testing.assert_allclose(cmds_n, cmds_t.numpy(), atol=ATOL,
                                   err_msg=f"port, step {step}")
        np.testing.assert_allclose(cmds_n, np.asarray(cmds_j), atol=ATOL,
                                   err_msg=f"jax, step {step}")
    assert_states_close(ctl.state_as_cascade_state("cpu"), cs, jcs)


def test_reset_matches_port_and_jax():
    rng = np.random.default_rng(7)
    ctl = native.ParallelControl("vel", N)
    root, act = random_states(rng), random_actions(rng, "vel")
    _, cs = tpx4.run("vel", tpx4.CascadeGains(), tpx4.init_state(N),
                     torch.from_numpy(root), torch.from_numpy(act), DT)
    _, jcs = jpx4.run("vel", jpx4.CascadeGains(), jpx4.init_state(N),
                      jnp.asarray(root), jnp.asarray(act), DT)
    ctl.update(root, act, DT)
    mask = np.zeros(N, bool)
    mask[::2] = True
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    ctl.reset(torch.from_numpy(mask), quats)
    cs = tpx4.reset_state(cs, torch.from_numpy(mask), torch.from_numpy(quats))
    jcs = jpx4.reset_state(jcs, jnp.asarray(mask), jnp.asarray(quats))
    st = ctl.state_as_cascade_state()
    assert_states_close(st, cs, jcs)
    assert not st.rate_int[mask].any() and st.rate_int[~mask].any()


def test_library_builds_under_build_and_nowhere_else(tmp_path, monkeypatch):
    assert native.lib_path().parent == REPO / "build" / "native"

    def snapshot(root):
        return {p: p.stat().st_mtime_ns for p in root.rglob("*")
                if p.is_file() and "__pycache__" not in p.parts}

    before = snapshot(REPO / "airgym_tpu_torch")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    built = native.build()
    assert built.parent == tmp_path / "native" and built.exists()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [built.name]
    assert snapshot(REPO / "airgym_tpu_torch") == before
    assert native.build() == built          # built once, then found


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "px4_cascade.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_bad_inputs_raise():
    ctl = native.ParallelControl("atti", 4)
    with pytest.raises(ValueError, match="actions"):
        ctl.update(np.zeros((4, 13)), np.zeros((4, 4)))
    with pytest.raises(ValueError, match="root_states"):
        ctl.update(np.zeros((3, 13)), np.zeros((4, 5)))
    with pytest.raises(ValueError, match="unknown mode"):
        native.ParallelControl("thrust", 4)

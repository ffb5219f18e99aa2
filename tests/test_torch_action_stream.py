"""The port's runtime action / state stream (utils/action_stream.py and
stream_play.py) against the JAX package's, over loopback sockets.

Every socket wait has its own deadline (``settimeout`` and bounded
loops), so a broken server fails a test instead of hanging the suite."""
import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.utils import action_stream as jstream
from airgym_tpu_torch import stream_play
from airgym_tpu_torch.cli import CONFIG_DIR
from airgym_tpu_torch.envs.hovering import HoveringState
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl.runner import Runner
from airgym_tpu_torch.utils import action_stream as tstream
from test_torch_env import (N, assert_core_close, assert_out_close,
                            hover_actions, to_port_core)

# inside the survival envelope (dist > 4 m kills), yawed by 0.3 rad
YAW = 0.3
NEW_TARGET = [np.cos(YAW), -np.sin(YAW), 0., np.sin(YAW), np.cos(YAW), 0.,
              0., 0., 1., 1., -0.5, 0.5, 0., 0., 0., 0., 0., 0.]


def recv_lines(sock, want, timeout=10.0):
    """Up to ``want`` JSON lines within ``timeout`` seconds."""
    sock.settimeout(0.2)
    buf, lines = b"", []
    deadline = time.monotonic() + timeout
    while len(lines) < want and time.monotonic() < deadline:
        try:
            data = sock.recv(65536)
        except socket.timeout:
            continue
        if not data:
            break
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                lines.append(json.loads(line))
    return lines


def test_retargetable_step_matches_jax():
    jt = jenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                         obs_noise=False)
    tt = tenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                         obs_noise=False, device="cpu")
    js = jt.initial_state(jax.random.PRNGKey(2))
    ts = HoveringState(core=to_port_core(js.core))
    target = np.tile(np.asarray(NEW_TARGET, np.float32), (N, 1))
    jstep = jstream.make_retargetable_step(jt)
    tstep = tstream.make_retargetable_step(tt)
    before = (tt.target, tt.target_pos, tt.target_yaw)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(2)
    for _ in range(12):
        act = hover_actions(rng)
        js, jo = jstep(js, jnp.asarray(act), jnp.asarray(target))
        ts, to = tstep(ts, torch.from_numpy(act), torch.from_numpy(target),
                       gen)
        assert not bool(np.asarray(jo.reset).any()), "window must not reset"
        assert_out_close(jo, to)
        assert_core_close(js.core, ts.core)
    assert (tt.target, tt.target_pos, tt.target_yaw) == before
    # the obs is relative to the new target, not the task's own
    np.testing.assert_allclose(to.obs[:, 9:12].numpy(),
                               ts.core.root[:, 0:3].numpy() - [1., -.5, .5],
                               atol=1e-5)

    def broken(*args):
        raise RuntimeError("step failed")

    tt.step = broken
    with pytest.raises(RuntimeError, match="step failed"):
        tstep(ts, torch.from_numpy(act), torch.from_numpy(target), gen)
    assert (tt.target, tt.target_pos, tt.target_yaw) == before


def jax_and_port_players(n, seed):
    """The JAX task and policy, and the port's with the JAX params carried
    in (checkpoint.from_jax) and the JAX task's initial state."""
    jt = jenvs.make_task("hovering", ctl_mode="rate", num_envs=n,
                         obs_noise=False)
    jtr = jppo.PPO(jt, jppo.PPOConfig(horizon=4, minibatch_size=8))
    jts = jtr.init(jax.random.PRNGKey(0))
    tt = tenvs.make_task("hovering", ctl_mode="rate", num_envs=n,
                         obs_noise=False, device="cpu")
    ttr = tppo.PPO(tt, tppo.PPOConfig(horizon=4, minibatch_size=8))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    tts = tckpt.restore(ttr.init(0), tckpt.from_jax(
        host(jts.params), host(jts.obs_rms), host(jts.value_rms)))
    js0 = jt.initial_state(jax.random.PRNGKey(seed))
    tt.initial_state = lambda generator: HoveringState(
        core=to_port_core(js0.core))
    return (jt, jtr, jts), (tt, ttr, tts)


def assert_messages_close(msgs_t, msgs_j, steps):
    assert [m["step"] for m in msgs_t] == [m["step"] for m in msgs_j] \
        == list(range(steps))
    for mt, mj in zip(msgs_t, msgs_j):
        assert mt.keys() == mj.keys() == {"step", "action", "root_state"}
        np.testing.assert_allclose(mt["action"], mj["action"], atol=1e-4)
        np.testing.assert_allclose(mt["root_state"], mj["root_state"],
                                   atol=1e-4)


def test_bridged_play_publishes_and_retargets_as_jax():
    (jt, jtr, jts), (tt, ttr, tts) = jax_and_port_players(4, seed=3)
    servers = {"jax": jstream.ActionStreamServer(),
               "port": tstream.ActionStreamServer()}
    clients = {k: socket.create_connection(s.address, timeout=5)
               for k, s in servers.items()}

    def run(steps):
        jstream.run_bridged_play(jt, jtr.model, jts, servers["jax"],
                                 steps=steps, seed=3)
        return tstream.run_bridged_play(tt, ttr, tts, servers["port"],
                                        steps=steps, seed=3, device="cpu")

    try:
        # phase 1: a few steps, the published messages
        run(5)
        msgs = {k: recv_lines(c, 5) for k, c in clients.items()}
        assert len(msgs["port"]) == 5
        assert all(len(m["action"]) == 4 and len(m["root_state"]) == 13
                   for m in msgs["port"])
        assert_messages_close(msgs["port"], msgs["jax"], 5)

        # phase 2: a target override, then a fresh run: it applies from
        # the run's second step (the loop polls after publishing step 0)
        for c in clients.values():
            c.sendall((json.dumps({"target_state": NEW_TARGET})
                       + "\n").encode())
        time.sleep(0.2)
        state, out = run(3)
        msgs = {k: recv_lines(c, 3) for k, c in clients.items()}
        assert_messages_close(msgs["port"], msgs["jax"], 3)
        # the obs is state_obs18 - target: its position block is relative
        # to the override (pre-reset root, so only envs that did not reset)
        alive = ~out.reset.numpy()
        assert alive.any()
        pos = state.core.root[:, 0:3].numpy()[alive]
        np.testing.assert_allclose(out.obs[:, 9:12].numpy()[alive],
                                   pos - np.asarray([1.0, -0.5, 0.5]),
                                   atol=1e-5)
        # malformed messages are ignored
        c = clients["port"]
        for bad in ({"target_state": [1.0, 2.0]}, {"target_state": "x"},
                    [1, 2], 7, {"other": 1}):
            c.sendall((json.dumps(bad) + "\n").encode())
        c.sendall(b"not json\n")
        time.sleep(0.2)
        tstream.run_bridged_play(tt, ttr, tts, servers["port"], steps=2,
                                 seed=3, device="cpu")
        assert len(recv_lines(c, 2)) == 2
    finally:
        for c in clients.values():
            c.close()
        for s in servers.values():
            s.close()


def test_bridged_play_needs_the_tasks_device():
    tt = tenvs.make_task("hovering", num_envs=4, device="cpu")
    ttr = tppo.PPO(tt, tppo.PPOConfig(horizon=4, minibatch_size=8))
    server = tstream.ActionStreamServer()
    try:
        # the default device is cuda: no GPU here, so it raises
        with pytest.raises(RuntimeError, match="CUDA"):
            tstream.run_bridged_play(tt, ttr, ttr.init(0), server, steps=1)
    finally:
        server.close()


def test_server_survives_client_disconnect():
    server = tstream.ActionStreamServer()
    try:
        c = socket.create_connection(server.address, timeout=5)
        server.publish({"step": 0})
        c.close()
        for i in range(1, 4):
            server.publish({"step": i})       # must not raise
        assert server.poll() == []
        # a second client still gets its lines
        c2 = socket.create_connection(server.address, timeout=5)
        server.publish({"step": 4})
        assert recv_lines(c2, 1) == [{"step": 4}]
        c2.close()
    finally:
        server.close()


PAD = "x" * 65536


def backpressure_run(server):
    """A client that reads nothing until 200 lines of 64 KiB padding are
    published, then drains the socket while the server is polled (which
    sends the port's backlogs) until nothing arrives for 0.5 s. Returns
    (the raw lines received, the bytes after the last newline, the
    longest publish in seconds)."""
    client = socket.create_connection(server.address, timeout=5)
    try:
        slowest = 0.0
        for i in range(200):
            t0 = time.monotonic()
            server.publish({"step": i, "pad": PAD})
            slowest = max(slowest, time.monotonic() - t0)
        client.settimeout(0.05)
        buf = b""
        deadline = time.monotonic() + 15.0
        idle_since = time.monotonic()
        while time.monotonic() < deadline:
            server.poll()
            try:
                data = client.recv(1 << 20)
            except socket.timeout:
                data = None
            if data:
                buf += data
                idle_since = time.monotonic()
            elif data == b"" or time.monotonic() - idle_since > 0.5:
                break
        *lines, tail = buf.split(b"\n")
        return lines, tail, slowest
    finally:
        client.close()


def parse_all(lines):
    out = []
    for line in lines:
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            out.append(None)
    return out


def test_backpressure_never_tears_a_line():
    server = tstream.ActionStreamServer()
    try:
        lines, tail, slowest = backpressure_run(server)
        assert slowest < 1.0, "publish blocked"
        msgs = parse_all(lines)
        assert None not in msgs, "a torn line reached the client"
        assert tail == b""
        steps = [m["step"] for m in msgs]
        assert all(m["pad"] == PAD for m in msgs)
        assert steps == sorted(set(steps)) and steps[-1] == 199
        # the socket took some; the backlog kept the line partly on the
        # wire, if any, and the newest 9 or 10
        assert 10 < len(steps) < 200
        assert server.dropped == 200 - len(steps)
        assert steps[-9:] == list(range(191, 200))
    finally:
        server.close()


def test_reference_server_tears_lines_under_backpressure():
    """The same run against the JAX package's server shows the fault the
    port repairs: a partial ``sendall`` on the non-blocking socket leaves
    part of a line on the wire, which the client receives unterminated or
    glued to a later line."""
    server = jstream.ActionStreamServer()
    try:
        lines, tail, _ = backpressure_run(server)
        assert None in parse_all(lines) or tail != b""
    finally:
        server.close()


def test_stream_play_cli(monkeypatch, capsys):
    clients = []

    class Connected(tstream.ActionStreamServer):
        """A server with a client connected before the first publish."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            clients.append(socket.create_connection(self.address,
                                                    timeout=5))

    monkeypatch.setattr(stream_play, "ActionStreamServer", Connected)
    args = ["--num_envs", "8", "--steps", "20", "--hz", "0", "--port", "0"]
    try:
        assert stream_play.main(args + ["--device", "cpu"]) == 0
        assert "streaming on" in capsys.readouterr().out
        msgs = recv_lines(clients[0], 20)
        assert [m["step"] for m in msgs] == list(range(20))
        assert all(np.isfinite(m["root_state"]).all() for m in msgs)
        with pytest.raises(RuntimeError, match="CUDA"):
            stream_play.main(args)
        assert len(clients) == 1            # raised before serving
    finally:
        for c in clients:
            c.close()


def test_stream_play_restores_a_checkpoint(tmp_path, monkeypatch, capsys):
    """``--checkpoint`` restores a .pth the CLI wrote: the published
    actions are the restored policy's (the boot as Player.rollout)."""
    with open(os.path.join(CONFIG_DIR, "ppo_hovering.yaml")) as f:
        cfg = yaml.safe_load(f)
    tt, ttr, _ = Runner().load(cfg).build({
        "task": "hovering", "ctl_mode": "rate", "num_envs": 8,
        "device": "cpu"})
    ts = ttr.init(11)
    with torch.no_grad():
        for p in ts.model.parameters():
            p.add_(0.05)
    tckpt.export_pth(str(tmp_path / "p.pth"), ts)
    clients = []

    class Connected(tstream.ActionStreamServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            clients.append(socket.create_connection(self.address,
                                                    timeout=5))

    monkeypatch.setattr(stream_play, "ActionStreamServer", Connected)
    try:
        stream_play.main(["--num_envs", "8", "--steps", "1", "--hz", "0",
                          "--port", "0", "--device", "cpu", "--seed", "4",
                          "--checkpoint", str(tmp_path / "p.pth")])
        (msg,) = recv_lines(clients[0], 1)
    finally:
        for c in clients:
            c.close()
    gen = torch.Generator().manual_seed(4)
    st = tt.initial_state(gen)
    _, out = tt.step(st, torch.zeros((8, 4)), gen)
    with torch.no_grad():
        mu, _, _ = ts.model(out.obs, ttr._rms(ts))
    np.testing.assert_allclose(msg["action"], mu[0].clamp(-1, 1).numpy(),
                               atol=1e-6)

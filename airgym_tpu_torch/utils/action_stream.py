"""Host-side runtime action / state stream (counterpart of
airgym_tpu/utils/action_stream.py): the analogue of the reference's
optional rospy bridge (reference hovering.py:149-156 publishes ``/action``
each step and subscribes ``/target_state`` to re-target the task
mid-rollout; :362-366 builds the env-0 action message).

The transport is a localhost TCP socket carrying newline-delimited JSON,
which a ROS relay node, AirGym-Real's onboard stack or netcat can
consume. It runs on the host at control rate, outside the device's step.

Protocol (one JSON object per line, either direction):
  out: {"step": int, "action": [A], "root_state": [13]}   (env 0)
  in:  {"target_state": [18]}   -> re-targets ALL envs (the reference
        callback repeats the incoming target over num_envs,
        hovering.py:154-156)

A slow client never stalls the loop and never receives part of a line:
each client has a backlog of whole lines, ``publish`` sends what its
socket takes and keeps the rest, and once the backlog passes
``MAX_BACKLOG`` lines (the reference publisher's rospy ``queue_size=10``)
its oldest unsent lines are dropped.
"""
from __future__ import annotations

import collections
import json
import socket
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from airgym_tpu_torch import device as device_mod
from airgym_tpu_torch.math import rotations as rot

MAX_BACKLOG = 10


class _Client:
    """A connected socket, its partial inbound line and its backlog of
    outbound lines; ``sent`` bytes of the first line are on the wire."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rx = b""
        self.tx: Deque[bytes] = collections.deque()
        self.sent = 0


class ActionStreamServer:
    """Non-blocking localhost pub / sub endpoint. ``port=0`` picks an
    ephemeral port (read it back from ``.address``). ``dropped`` counts
    the lines dropped from backlogs."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self._srv.setblocking(False)
        self.address = self._srv.getsockname()
        self.dropped = 0
        self._clients: List[_Client] = []

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._srv.accept()
            except BlockingIOError:
                return
            sock.setblocking(False)
            self._clients.append(_Client(sock))

    def _drop(self, c: _Client) -> None:
        self._clients.remove(c)
        try:
            c.sock.close()
        except OSError:
            pass

    def _flush(self, c: _Client) -> bool:
        """Send what ``c``'s socket takes of its backlog; False once the
        client is gone (and dropped)."""
        while c.tx:
            line = c.tx[0]
            try:
                c.sent += c.sock.send(line[c.sent:])
            except (BlockingIOError, InterruptedError):
                return True               # backpressure: keep the rest
            except OSError:
                self._drop(c)
                return False
            if c.sent == len(line):
                c.tx.popleft()
                c.sent = 0
        return True

    def publish(self, msg: Dict[str, Any]) -> None:
        """Queue ``msg`` as one line for every client and send what each
        socket takes."""
        self._accept()
        line = (json.dumps(msg) + "\n").encode()
        for c in list(self._clients):
            c.tx.append(line)
            # a line partly on the wire stays: dropping it would tear it
            first = 1 if c.sent else 0
            while len(c.tx) > MAX_BACKLOG:
                del c.tx[first]
                self.dropped += 1
            self._flush(c)

    def poll(self) -> List[Any]:
        """Send pending backlogs, then drain the whole JSON lines received
        from any client (a line that is not JSON is skipped)."""
        self._accept()
        out: List[Any] = []
        for c in list(self._clients):
            if not self._flush(c):
                continue
            try:
                data = c.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                self._drop(c)
                continue
            if not data:                  # orderly shutdown
                self._drop(c)
                continue
            c.rx += data
            while b"\n" in c.rx:
                line, c.rx = c.rx.split(b"\n", 1)
                if line.strip():
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass
        return out

    def close(self) -> None:
        for c in list(self._clients):
            self._drop(c)
        self._srv.close()


def make_retargetable_step(task):
    """``step_fn(state, actions, target, generator)``: ``task.step`` with
    the target [N, 18] as an argument. Hovering reads ``task.target``,
    ``target_pos`` and ``target_yaw``; the three are swapped for the call
    (the yaw from the target's rotation as ``envs/hovering.py`` derives
    it) and restored after it, also when the step raises."""

    def step_fn(state, actions, target, generator):
        old = (task.target, task.target_pos, task.target_yaw)
        try:
            task.target = target
            task.target_pos = target[:, 9:12]
            tmat = target[:, 0:9].reshape(-1, 3, 3)
            task.target_yaw = rot.matrix_to_euler_xyz(tmat)[..., 2]
            return task.step(state, actions, generator)
        finally:
            task.target, task.target_pos, task.target_yaw = old

    return step_fn


def _target_from(msg, shape, device) -> Optional[torch.Tensor]:
    """The [N, 18] target a ``{"target_state": [18]}`` message asks for,
    or None for any other or malformed message."""
    if not isinstance(msg, dict) or "target_state" not in msg:
        return None
    try:
        tgt = np.asarray(msg["target_state"], np.float32)
    except (TypeError, ValueError):
        return None
    if tgt.shape != (shape[1],):
        return None
    return torch.from_numpy(tgt).to(device).expand(shape)


@torch.no_grad()
def run_bridged_play(task, model_or_trainer, ts, server: ActionStreamServer,
                     steps: int, seed: int = 0, env_index: int = 0,
                     realtime_hz: Optional[float] = None, device=None):
    """Deterministic play with the stream attached. Boots as
    ``Player.rollout`` does (a generator seeded with ``seed``,
    ``initial_state`` and one zero-action step), then each tick: the
    action ``clamp(mu, -1, 1)``, one step, env ``env_index``'s action and
    root published (one host copy of A + 13 floats, the loop's only
    sync), and the pending ``target_state`` messages applied from the
    next step on.

    ``model_or_trainer``: the PPO trainer (its input normalisation as
    configured) or the model itself (called with ``ts.obs_rms``).
    ``device`` is the task's (default ``cuda``; raises without a GPU).
    ``realtime_hz`` paces the loop (100.0 is the reference's dt = 0.01);
    None runs as fast as the host allows. Returns the last (state, out).
    """
    dev = device_mod.resolve(device)
    if torch.device(task.device).type != dev.type:
        raise ValueError(f"the task lives on {task.device}, not on {dev}")
    if isinstance(model_or_trainer, torch.nn.Module):
        model, rms = model_or_trainer, ts.obs_rms
    else:
        model, rms = ts.model, model_or_trainer._rms(ts)
    n = task.cfg.num_envs
    step_fn = make_retargetable_step(task)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = task.initial_state(gen)
    state, out = task.step(
        state, torch.zeros((n, task.cfg.num_actions), device=dev), gen)
    target = task.target
    t_next = time.monotonic()
    for t in range(steps):
        mu, _, _ = model(out.obs, rms)
        action = torch.clamp(mu, -1.0, 1.0)
        state, out = step_fn(state, action, target, gen)
        row = torch.cat([action[env_index],
                         state.core.root[env_index, :13]]).cpu().double()
        na = action.shape[1]
        server.publish({"step": t, "action": row[:na].tolist(),
                        "root_state": row[na:].tolist()})
        for msg in server.poll():
            new = _target_from(msg, task.target.shape, dev)
            if new is not None:
                target = new
        if realtime_hz:
            t_next += 1.0 / realtime_hz
            delay = t_next - time.monotonic()
            if delay > 0:
                time.sleep(delay)
    return state, out

"""The work of each kernel and of a whole step, frozen with the benchmark
so that a later edit of the program cannot move the yardstick.

Copied from ``chip_smoke.py`` (``PEAK_*``, ``RAY_OPS`` ... ``TABLE_OPS``,
``bound_ms``, ``mlp_macs``, ``rollout_bound``, ``update_bound``,
``cast_records``, ``render_ops``, ``render_bound``, ``cnn_macs``) and from
``airgym_tpu_torch/kernels/hovering_ab.py`` (``STEP_OPS``, ``RESET_OPS``,
``LAUNCH_OPS``, ``bound``) as they stood when the benchmark was defined;
the program's constants they read (the packed record's 40 rows, the
rollout record's width, the update's parameter count) are written out
here. Operations are float32 operations as the sources count them; bytes
count each input read once and each output written once.
"""
from __future__ import annotations

import torch

# H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s float32 outside the
# tensor cores, 989 TFLOP/s bf16 on them, 3.35 TB/s of HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# ---- fused rollout (B2) and update (B3): chip_smoke.py ----------------------
PACKED_ROWS = 40                      # ops/fused_hovering._F
OBS = {"hovering": 18, "balloon": 18, "tracking": 48}
ACT = 4


def least_s(flops: float, nbytes: float, peak: float = PEAK_FP32) -> float:
    """The least time of a piece of work: its operations at ``peak`` or its
    bytes at the HBM rate, whichever is longer."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def mlp_macs(obs: int) -> int:
    """Multiply-adds of one forward pass of the [64,128,64] net to mu(4) +
    value."""
    return 64 * obs + 128 * 64 + 64 * 128 + 5 * 64


def mlp_params(obs: int) -> int:
    """ops/fused_update.num_params: 18,121 at 18 features."""
    return (64 * obs + 64) + (128 * 64 + 128) + (64 * 128 + 64) \
        + (5 * 64 + 5) + ACT


def rollout_work(task: str, n: int, steps: int):
    """(flops, bytes) of one fused rollout launch: the MLP's products; the
    packed state read and written, the record written, the weights read."""
    obs = OBS[task]
    flops = 2.0 * mlp_macs(obs) * n * steps
    n_weights = mlp_params(obs) + 2 * obs          # + the obs mean, 1/std
    nbytes = 4.0 * (2 * PACKED_ROWS * n + steps * (obs + 13) * n + n_weights)
    return flops, nbytes


def update_work(obs: int, batch: int, mini_epochs: int):
    """(flops, bytes) of one fused update call: forward, weight gradients
    and input gradients (none into the observation) of every sample in
    every mini-epoch; the batch read once, parameters and moments moved."""
    per_sample = 2.0 * (2 * mlp_macs(obs) + mlp_macs(obs) - 64 * obs)
    nbytes = 4.0 * (batch * (obs + 4 + 3 + 4) + 6 * mlp_params(obs))
    return per_sample * batch * mini_epochs, nbytes


# ---- env-only kernel (B1): kernels/hovering_ab.py ---------------------------
# every env-step: the controller 138, the physics 177, the reward without
# its action terms 136, the time-out test 1; each reset 137; each env once
# 57
STEP_OPS = 138 + 177 + 136 + 1
RESET_OPS = 137
LAUNCH_OPS = 2 + 4 + 3 * 17
ENV_ROWS = 29                         # ops/fused_hovering.NROWS
HOVER_EPISODE = 2400                  # steps: 24 s at dt 0.01


def env_work(n: int, steps: int, resets: int):
    """(flops, bytes) of one env-only launch: the state read and written
    once, the reward sums written once."""
    ops = STEP_OPS * n * steps + RESET_OPS * resets + LAUNCH_OPS * n
    return float(ops), 4.0 * (2 * ENV_ROWS * n + n + 4)


# ---- render + process (B6): chip_smoke.py -----------------------------------
RAY_OPS = 18
GROUND_OPS = 5
PROCESS_PIXEL_OPS = 5 + 2 * 17
BLUR_TAP_OPS = 2
CAST_OPS = (36, 13, 32, 60)
PREP_OPS = (22, 11, 16, 30)
TABLE_OPS = (11, 8)


def cast_records(inp) -> torch.Tensor:
    """[N, 4] records each env's prepass keeps, by kind: the valid ones of
    the groups of 8 that start below the live count."""
    out, p = [], 0
    for k, cnt in enumerate(inp.counts):
        lim = torch.clamp((inp.live[:, k] + 7) // 8 * 8, max=cnt)
        idx = torch.arange(cnt, device=inp.prims.device)
        valid = inp.prims[:, p:p + cnt, 0] > 0.0
        out.append((valid & (idx[None] < lim[:, None])).sum(1))
        p += cnt
    return torch.stack(out, 1)


def render_work(inp):
    """(flops, bytes) of one render + process on these inputs (a
    ``render/raycast.RenderInputs``): the records the prepasses keep after
    culling, the pixels, the blur's taps inside the image, each env's ray
    tables; the inputs read once and the image written once."""
    n, W, H = inp.origins.shape[0], inp.cfg.width, inp.cfg.height
    kept = cast_records(inp).to(torch.float64).sum(0).tolist()
    per_pix = RAY_OPS + GROUND_OPS * int(inp.ground) + PROCESS_PIXEL_OPS
    ops = n * W * H * per_pix + n * (TABLE_OPS[0] * W + TABLE_OPS[1] * H)
    ops += sum(c * (W * H * k + q)
               for c, k, q in zip(kept, CAST_OPS, PREP_OPS))
    ops += n * BLUR_TAP_OPS * (5 * W - 6) * (5 * H - 6)
    nbytes = sum(x.numel() * x.element_size() for x in (
        inp.origins, inp.rots, inp.prims, inp.live, inp.taps))
    nbytes += 4 * n + 4 * n * W * H
    return float(ops), float(nbytes)


# ---- the CNN encoder: chip_smoke.cnn_macs -----------------------------------
def cnn_macs(w: int, h: int) -> int:
    """The convolutions' own multiply-adds of one image's forward pass:
    conv0 5x5 1 -> 16 at the 2 x 2 outputs of each 4 x 4 cell, conv1 3x3
    16 -> 32 per cell, conv2 3x3 32 -> 64 per conv2 position."""
    hc, wc = h // 4, w // 4
    ho, wo = (hc + 1) // 2, (wc + 1) // 2
    return hc * wc * 4 * 16 * 25 + hc * wc * 32 * 16 * 9 + ho * wo * 64 * 32 * 9


def cnn_train_flops(w: int, h: int, images: int) -> float:
    """Forward and backward of ``images`` images without recomputation:
    the backward is twice the forward (input and weight gradients)."""
    return 3.0 * 2.0 * cnn_macs(w, h) * images


def cnn_forward_flops(w: int, h: int, images: int) -> float:
    return 2.0 * cnn_macs(w, h) * images

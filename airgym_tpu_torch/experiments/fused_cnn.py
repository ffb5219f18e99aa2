"""Fused CNN encoder: conv0 -> ReLU -> BN -> conv1 -> ReLU -> BN -> conv2
-> ReLU -> BN -> mean pool in one forward kernel, and its parameter
gradients in one backward kernel (counterpart of
airgym_tpu/experiments/fused_cnn.py).

``encode_pooled`` launches ``csrc/fused_cnn.cu`` for CUDA tensors (or
raises) and runs ``encode_pooled_plain`` / ``encode_pooled_plain_bwd``
for CPU tensors. The stack is computed in the conv0 cell grid, the folded
form of the JAX package (``models/actor_critic._FoldedConv0`` /
``_CellConv1``): for a [B, H, W, 1] image (H, W divisible by 4) the cell
grid is hc x wc = H/4 x W/4 and conv2's output grid ho x wo =
ceil(hc/2) x ceil(wc/2).

- x0 = the 8 x 8-pixel stride-4 patches of the image padded by 2, 64
  values per cell in the order (a, c, p, q) of pixel (4i - 2 + 2a + p,
  4j - 2 + 2c + q); a0 = BN0(ReLU(x0 @ w0 + b0)) [hc, wc, 64], channel =
  (output pixel parity p * 2 + q) * 16 + filter;
- a1 = BN1(ReLU(z1 @ w1 + b1)) [hc, wc, 32] with z1 the 2 x 2-cell
  patches of a0 padded top / left;
- a2 = BN2(ReLU(z2 @ w2 + b2)) [ho, wo, 64] with z2 the 3 x 3 stride-2
  patches of a1 padded by 1; pooled = sum(a2) * (1 / (ho * wo)).

Rounding points, as the JAX kernels: products take compute-dtype
operands (the image and the three weight matrices in bf16 or float32) and
sum in float32; bias, ReLU and BN are applied in float32; a0 and a1 are
rounded to the compute dtype only as matmul operands. The backward rounds
g2, g1 and g0 before their products, sums each element of dA1 and dA0
over all of its taps in float32, and returns dw0 / dw1 / dw2 rounded to
the weights' dtype.

GRADIENT CONTRACT: ``encode_pooled`` differentiates with respect to
``ws`` only. The image is rollout data: it is detached, and the backward
returns ``None`` for it (the JAX function ``stop_gradient``s it).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import torch
import torch.nn.functional as F

from airgym_tpu_torch.kernels import build

MAT_KEYS = ("w0", "w1", "w2")
ROW_KEYS = ("b0", "s0", "t0", "b1", "s1", "t1", "b2", "s2", "t2")
W_KEYS = ("w0", "b0", "s0", "t0", "w1", "b1", "s1", "t1",
          "w2", "b2", "s2", "t2")
MAT = {"w0": (64, 64), "w1": (256, 32), "w2": (288, 64)}
ROW = {"b0": 64, "s0": 64, "t0": 64, "b1": 32, "s1": 32, "t1": 32,
       "b2": 64, "s2": 64, "t2": 64}
# the kernels' flat gradient: dw0, dw1, dw2 (row-major), then the rows in
# ROW_KEYS order (csrc/fused_cnn.cu O_W0 .. O_ROWS)
N_MAT = sum(r * c for r, c in MAT.values())          # 30,720
N_ROWS = sum(ROW.values())                           # 480
N_PARAM = N_MAT + N_ROWS

KERNEL = build.CudaKernel("fused_cnn", {
    "fused_cnn_fwd_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "fused_cnn_bwd_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "fused_cnn_smem_bytes": [ctypes.c_int] * 2,
    "fused_cnn_workspace_floats": [ctypes.c_int] * 3,
    "fused_cnn_fwd_workspace_bytes": [ctypes.c_int] * 3,
    "fused_cnn_fwd_blocks": [ctypes.c_int],
    "fused_cnn_bwd_blocks": [ctypes.c_int],
    "fused_cnn_mma_probe": [ctypes.c_void_p] * 5})


def geometry(h: int, w: int):
    """(hc, wc, ho, wo): the conv0 cell grid and conv2's output grid."""
    hc, wc = h // 4, w // 4
    return hc, wc, (hc + 1) // 2, (wc + 1) // 2


# ---- plain version ---------------------------------------------------------


def _x0(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] image -> conv0's cell patches [B, hc, wc, 64] (float32)."""
    b, h, w = x.shape
    xp = F.pad(x.to(torch.float32), (2, 2, 2, 2))
    p = xp.unfold(1, 8, 4).unfold(2, 8, 4)             # [B, hc, wc, dr, dc]
    p = p.reshape(b, h // 4, w // 4, 4, 2, 4, 2)       # a, p, c, q
    return p.permute(0, 1, 2, 3, 5, 4, 6).reshape(b, h // 4, w // 4, 64)


def _z1(a0c: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    a0p = F.pad(a0c, (0, 0, 1, 0, 1, 0))
    return torch.cat([a0p[:, a:a + hc, c:c + wc] for a in (0, 1)
                      for c in (0, 1)], dim=-1)


def _z2(a1c: torch.Tensor, ho: int, wo: int) -> torch.Tensor:
    a1p = F.pad(a1c, (0, 0, 1, 1, 1, 1))
    return torch.cat([a1p[:, di:di + 2 * ho - 1:2, dj:dj + 2 * wo - 1:2]
                      for di in range(3) for dj in range(3)], dim=-1)


def _layer(z, w, b, s, t):
    """(r, a): r = ReLU(z @ w + b), a = r * s + t, all float32."""
    r = torch.relu(z @ w.to(torch.float32) + b)
    return r, r * s + t


def _stack_plain(x: torch.Tensor, ws: List[torch.Tensor]):
    """Forward of the stack -> (pooled [B, 64], residuals)."""
    dt, f32 = x.dtype, torch.float32
    k = dict(zip(W_KEYS, ws))
    hc, wc, ho, wo = geometry(x.shape[1], x.shape[2])
    rnd = lambda a: a.to(dt).to(f32)
    x0 = _x0(x)
    r0, a0 = _layer(x0, k["w0"], k["b0"], k["s0"], k["t0"])
    z1 = _z1(rnd(a0), hc, wc)
    r1, a1 = _layer(z1, k["w1"], k["b1"], k["s1"], k["t1"])
    z2 = _z2(rnd(a1), ho, wo)
    r2, a2 = _layer(z2, k["w2"], k["b2"], k["s2"], k["t2"])
    pooled = a2.sum(dim=(1, 2)) * (1.0 / (ho * wo))
    return pooled, (x0, r0, z1, r1, z2, r2)


def encode_pooled_plain(x: torch.Tensor, ws: List[torch.Tensor]
                        ) -> torch.Tensor:
    """[B, H, W] image in the compute dtype, the 12 packed weights in
    W_KEYS order (matrices in the compute dtype, rows float32 [n]) ->
    pooled [B, 64] float32."""
    return _stack_plain(x, ws)[0]


def encode_pooled_plain_bwd(x: torch.Tensor, ws: List[torch.Tensor],
                            dp: torch.Tensor) -> List[torch.Tensor]:
    """The 12 parameter gradients (float32, W_KEYS order) of
    ``sum(encode_pooled_plain(x, ws) * dp)``, in the JAX backward kernel's
    order: recompute, then conv2, conv1, conv0."""
    dt, f32 = x.dtype, torch.float32
    k = dict(zip(W_KEYS, ws))
    b = x.shape[0]
    hc, wc, ho, wo = geometry(x.shape[1], x.shape[2])
    rnd = lambda a: a.to(dt).to(f32)
    _, (x0, r0, z1, r1, z2, r2) = _stack_plain(x, ws)
    flat = lambda a: a.reshape(-1, a.shape[-1])
    sum_ = lambda a: a.sum(dim=(0, 1, 2))

    dy2 = (dp.to(f32) * (1.0 / (ho * wo)))[:, None, None, :].expand(
        b, ho, wo, 64)
    g2 = dy2 * k["s2"] * (r2 > 0.0)
    g2c = rnd(g2)
    out = {"s2": sum_(dy2 * r2), "t2": sum_(dy2), "b2": sum_(g2),
           "w2": flat(z2).T @ flat(g2c)}
    dz2 = g2c @ k["w2"].to(f32).T                         # [B, ho, wo, 288]
    da1 = torch.zeros((b, hc + 2, wc + 2, 32), dtype=f32, device=x.device)
    for tap in range(9):
        di, dj = divmod(tap, 3)
        da1[:, di:di + 2 * ho - 1:2, dj:dj + 2 * wo - 1:2] += \
            dz2[..., tap * 32:(tap + 1) * 32]
    da1 = da1[:, 1:hc + 1, 1:wc + 1]

    g1 = da1 * k["s1"] * (r1 > 0.0)
    g1c = rnd(g1)
    out.update(s1=sum_(da1 * r1), t1=sum_(da1), b1=sum_(g1),
               w1=flat(z1).T @ flat(g1c))
    dz1 = g1c @ k["w1"].to(f32).T                         # [B, hc, wc, 256]
    da0 = torch.zeros((b, hc + 1, wc + 1, 64), dtype=f32, device=x.device)
    for a in (0, 1):
        for c in (0, 1):
            tap = a * 2 + c
            da0[:, a:a + hc, c:c + wc] += dz1[..., tap * 64:(tap + 1) * 64]
    da0 = da0[:, 1:, 1:]

    g0 = da0 * k["s0"] * (r0 > 0.0)
    out.update(s0=sum_(da0 * r0), t0=sum_(da0), b0=sum_(g0),
               w0=flat(x0).T @ flat(rnd(g0)))
    return [out[key] for key in W_KEYS]


# ---- the kernels -------------------------------------------------------------


def _check(x: torch.Tensor, ws: List[torch.Tensor]) -> None:
    if x.dim() != 3 or x.shape[1] % 4 or x.shape[2] % 4:
        raise ValueError(f"the fused CNN needs H and W divisible by 4, got "
                         f"an image of {tuple(x.shape)}; use "
                         f"CNNEncoder(impl='auto') for other shapes")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got "
                         f"{x.dtype}")
    for key, w in zip(W_KEYS, ws):
        shape, dtype = ((MAT[key], x.dtype) if key in MAT
                        else ((ROW[key],), torch.float32))
        if tuple(w.shape) != shape or w.dtype != dtype \
                or w.device != x.device:
            raise ValueError(f"{key}: want {dtype} {shape} on {x.device}, "
                             f"got {w.dtype} {tuple(w.shape)} on {w.device}")


def _kernel_args(x, ws):
    k = dict(zip(W_KEYS, ws))
    lib = KERNEL.lib()
    h, w = x.shape[1], x.shape[2]
    if lib.fused_cnn_smem_bytes(h, w) == 0:
        raise ValueError(f"a {h} x {w} image exceeds one block's shared "
                         f"memory in csrc/fused_cnn.cu")
    rows = torch.cat([k[key].reshape(-1) for key in ROW_KEYS]).contiguous()
    mats = [k[key].contiguous() for key in MAT_KEYS]
    return lib, x.contiguous(), mats, rows, int(x.dtype == torch.bfloat16)


def _fwd(x: torch.Tensor, ws: List[torch.Tensor]) -> torch.Tensor:
    """Pooled features: the forward kernel for CUDA tensors (or raises),
    the plain version for CPU tensors."""
    _check(x, ws)
    if not x.is_cuda:
        return encode_pooled_plain(x, ws)
    lib, xc, mats, rows, is_bf16 = _kernel_args(x, ws)
    b, h, w = x.shape
    blocks = lib.fused_cnn_fwd_blocks(b)
    if blocks <= 0:
        raise RuntimeError("fused_cnn_fwd_blocks: the device's SM count "
                           "could not be read")
    # the bf16 forward's a1, one slice per block (none in float32)
    work = torch.empty((blocks * lib.fused_cnn_fwd_workspace_bytes(
        h, w, is_bf16),), dtype=torch.uint8, device=x.device)
    out = torch.empty((b, 64), dtype=torch.float32, device=x.device)
    KERNEL.call("fused_cnn_fwd_launch", xc.data_ptr(),
                *[m.data_ptr() for m in mats], rows.data_ptr(),
                work.data_ptr(), out.data_ptr(), b, h, w, is_bf16,
                torch.cuda.current_stream(x.device).cuda_stream)
    KERNEL.launches["fused_cnn_fwd"] += 1
    return out


def _bwd(x: torch.Tensor, ws: List[torch.Tensor], dp: torch.Tensor
         ) -> List[torch.Tensor]:
    """The 12 float32 parameter gradients: the backward and reduction
    kernels for CUDA tensors (or raises), the plain version for CPU
    tensors."""
    _check(x, ws)
    if tuple(dp.shape) != (x.shape[0], 64):
        raise ValueError(f"cotangent must be [{x.shape[0]}, 64], got "
                         f"{tuple(dp.shape)}")
    if not x.is_cuda:
        return encode_pooled_plain_bwd(x, ws, dp)
    lib, xc, mats, rows, is_bf16 = _kernel_args(x, ws)
    b, h, w = x.shape
    blocks = lib.fused_cnn_bwd_blocks(b)
    work = torch.empty((blocks * lib.fused_cnn_workspace_floats(h, w,
                                                                 is_bf16),),
                       dtype=torch.float32, device=x.device)
    part = torch.empty((blocks, N_PARAM), dtype=torch.float32,
                       device=x.device)
    grads = torch.empty((N_PARAM,), dtype=torch.float32, device=x.device)
    dpc = dp.to(torch.float32).contiguous()
    KERNEL.call("fused_cnn_bwd_launch", xc.data_ptr(), dpc.data_ptr(),
                *[m.data_ptr() for m in mats], rows.data_ptr(),
                work.data_ptr(), part.data_ptr(), grads.data_ptr(), b, h, w,
                is_bf16, torch.cuda.current_stream(x.device).cuda_stream)
    KERNEL.launches["fused_cnn_bwd"] += 1
    return unflatten_grads(grads)


def unflatten_grads(flat: torch.Tensor) -> List[torch.Tensor]:
    """The kernels' flat gradient -> the 12 tensors in W_KEYS order."""
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for key in MAT_KEYS:
        n = MAT[key][0] * MAT[key][1]
        out[key] = flat[off:off + n].reshape(MAT[key])
        off += n
    for key in ROW_KEYS:
        out[key] = flat[off:off + ROW[key]]
        off += ROW[key]
    return [out[key] for key in W_KEYS]


class _EncodePooled(torch.autograd.Function):
    """pooled = stack(x; ws); the backward returns None for the image and
    each parameter gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, *ws):
        ctx.save_for_backward(x, *ws)
        return _fwd(x, list(ws))

    @staticmethod
    def backward(ctx, dp):
        x, *ws = ctx.saved_tensors
        grads = _bwd(x, ws, dp)
        return (None, *[g.to(w.dtype) for g, w in zip(grads, ws)])


def encode_pooled(x_nhwc: torch.Tensor, ws: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """Fused CNN stack: normalised [B, H, W, 1] image (in the compute
    dtype) -> pooled [B, 64] float32.

    ``ws``: w0 [64, 64] (folded conv0 matrix), w1 [256, 32] (cell conv1),
    w2 [288, 64] (conv2 im2col, (di, dj, cin) row order), conv biases b0
    [64] (tiled x4) / b1 [32] / b2 [64], folded-BN scale / bias s0, t0
    [64] (tiled x4) / s1, t1 [32] / s2, t2 [64]. The matrices are cast to
    the image's dtype and the rows to float32 here, so their gradients
    come back through those casts.

    Differentiates with respect to ``ws`` only: the image is detached and
    gets no gradient (the backward returns None for it). A caller that
    needs d/d(image) must use ``CNNEncoder(impl='auto')``.
    """
    b, h, w, c = x_nhwc.shape
    if c != 1:
        raise ValueError(f"one input channel expected, got {c}")
    x = x_nhwc.detach()[..., 0]
    packed = [ws[k].to(x.dtype) if k in MAT
              else ws[k].reshape(-1).to(torch.float32) for k in W_KEYS]
    return _EncodePooled.apply(x, *packed)

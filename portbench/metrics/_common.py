"""Shared arithmetic of the per-layer readers. Every reader takes the
traced run's context: ``trace`` (trace.Reading of the profiled stretch),
``least`` (counted least seconds by layer in it, counts/work.py) and,
in training cells, ``spans`` (the
benchmark's timed spans over the window). A reader that finds nothing
to read returns None."""
from __future__ import annotations

# profiler names of the device kernels of each layer
KERNELS = {"rollout_kernel": ("fused_rollout_kernel",),
           "update_kernel": ("update_kernel",),
           "env_kernel": ("fused_hovering_kernel",),
           "render_kernel": ("render_process_kernel",),
           # cuDNN's convolutions and their layout copies (chip_smoke.py's
           # CUDNN_WORDS)
           "cnn": ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm",
                   "nchwtonhwc", "nhwctonchw", "winograd", "convolve")}


def span_ms(ctx, name):
    spans = ctx.get("spans")
    if spans is None or not spans.count.get(name):
        return None
    return 1e3 * spans.total[name] / spans.count[name]


def kernel_s(ctx, layer, names=None):
    """Device seconds of the kernels whose names hold one of ``names``
    (the layer's ``KERNELS`` by default)."""
    names = names or KERNELS[layer]
    hits = [e for e in ctx["trace"].events
            if any(w in e[2].lower() for w in names)]
    return sum(e[1] - e[0] for e in hits) * 1e-6


def roofline(ctx, layer, names=None):
    """Least time of the layer's counted work over its kernels' device
    time, in % (``names`` as in ``kernel_s``: a reader of a layer this
    file does not list gives its own)."""
    least = ctx["least"].get(layer)
    t = kernel_s(ctx, layer, names)
    if not least or t <= 0.0:
        return None
    return 100.0 * least / t


def idle_pct(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu(ctx):
    """The whole stretch's counted work at each part's peak over its wall
    time, in %."""
    least = sum(ctx["least"].values())
    if not least:
        return None
    return 100.0 * least / ctx["trace"].window_s

"""The exchange's share of the profiled stretch on the rank that waits
least, in %: each rank's NCCL kernels' union of intervals over its
stretch's wall time, the least over the ranks. A rank's NCCL kernels
also run while it waits for a slower rank; the slowest rank waits least,
so its share is nearest the transfers' own."""


def read(ctx):
    shares = [s / w for s, w in ctx.get("exchange") or [] if s > 0.0]
    if not shares:
        return None
    return 100.0 * min(shares)

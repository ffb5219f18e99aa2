"""Multi-GPU training over torch.distributed (parallel/dist.py)."""

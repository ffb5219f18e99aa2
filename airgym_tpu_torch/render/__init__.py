"""Depth camera: the plain renderer and the fused render + post-process
kernel."""

"""The plain PyTorch versions of ``airgym_tpu_torch`` that the benchmark's
reference runs, frozen and cut to what the two configurations use: the
Hovering and Planning tasks in PX4 rate mode, the physics, the hash RNG,
the plain versions of the fused rollout, update and render kernels, the
shared-trunk fixed-sigma actor-critic with its CNN encoder, and the PPO
trainers. No CUDA kernel and no multi-rank path; imports stay inside this
package, so a later edit of the program cannot move the yardstick."""

"""See the counterpart package under airgym_tpu/."""

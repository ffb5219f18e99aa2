"""Host-side utilities (counterpart of airgym_tpu/utils/)."""

"""Distogram pretraining on the port (counterpart of alphafold2_tpu/training/,
the plain single-device path: losses, synthetic data, the train step)."""

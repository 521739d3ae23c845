"""Reliability for the port (counterpart of alphafold2_tpu/reliability/):
the serving engine's circuit breaker (`breaker`), the training faults of
the chaos plans (`faults`) and preemption-safe shutdown (`preemption`)."""

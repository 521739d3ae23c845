"""Self-protection for the serving engine (counterpart of
alphafold2_tpu/reliability/, the circuit breaker only)."""

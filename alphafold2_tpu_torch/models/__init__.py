"""Model layer: configuration, trunk, model and the JAX weights bridge."""

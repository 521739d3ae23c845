"""Host-side helpers: alignment parsing."""

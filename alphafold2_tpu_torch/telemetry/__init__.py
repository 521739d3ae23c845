"""Measurement of the port on the card."""

"""The sequence -> structure inference pipeline."""

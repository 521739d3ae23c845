"""Distogram centering, MDS and PDB I/O."""

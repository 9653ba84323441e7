"""Signature schemes: the host BN254 scheme and its device verification engine."""

"""Diagnostic scripts of the PyTorch port (run with ``python3 -m``)."""

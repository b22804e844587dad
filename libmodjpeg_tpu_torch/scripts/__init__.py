"""Command-line scripts of the PyTorch port (run with ``python -m``)."""

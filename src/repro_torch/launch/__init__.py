"""repro_torch.launch — command-line drivers (``python -m repro_torch.launch.mine``)."""

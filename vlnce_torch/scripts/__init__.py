"""Command-line tools of the port, each run as `python -m
vlnce_torch.scripts.<name>`."""

"""Command-line scripts of the port (``python3 -m ferreus_rbf_tpu_torch.scripts.<name>``)."""

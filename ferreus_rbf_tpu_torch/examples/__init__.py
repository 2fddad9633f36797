"""The JAX package's nine example scripts (``examples/``), ported: each runs
as ``python3 -m ferreus_rbf_tpu_torch.examples.<name> [--device cpu]``,
prints the same summary lines as its counterpart and writes its artifacts
into the working directory."""

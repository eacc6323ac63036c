"""Command lines: ``python -m superslomo_tpu_torch.cli.train``,
``…cli.evaluate_interpolation``, ``…cli.evaluate_flow`` and
``…cli.visualize``, with the JAX package's arguments and
``--device {cuda,cpu}``."""

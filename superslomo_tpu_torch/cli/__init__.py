"""Command lines: ``python -m superslomo_tpu_torch.cli.train`` and
``python -m superslomo_tpu_torch.cli.evaluate_interpolation``, with the JAX
package's arguments and ``--device {cuda,cpu}``."""

"""Command lines: ``python -m superslomo_tpu_torch.cli.train``,
``…cli.evaluate_interpolation`` (both also under ``torch.distributed.run``,
one rank a card), ``…cli.evaluate_flow`` and ``…cli.visualize``, with the
JAX package's arguments and ``--device {cuda,cpu}``; and
``…cli.convert_checkpoint``, a host tool."""

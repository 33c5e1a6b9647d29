"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(``quickstart``, ``serve_with_plan``); each runs on the GPU unless given
``--device cpu``."""

"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(``quickstart``, ``serve_with_plan``, ``search_and_enact``, ``train_lm``,
``serve_decode``); each runs on the GPU unless given ``--device cpu``."""

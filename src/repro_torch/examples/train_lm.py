"""Data-parallel training with a DisCo-searched strategy (port of
``examples/train_lm.py``).

    python -m repro_torch.examples.train_lm                # on the GPU
    python -m repro_torch.examples.train_lm --device cpu --steps 20

Trains a reduced LM (qwen2-0.5b unless ``--arch`` says otherwise) for 200
steps unless ``--steps`` says otherwise, on the synthetic bigram corpus,
batch 16 x 64, its gradient sync enacted from the DisCo search
(``--strategy auto``), through :func:`repro_torch.launch.train.main` (the
full launcher, with checkpoints and resume).  Every other argument is the
launcher's.
"""
from __future__ import annotations

import sys


def main(argv=None) -> dict:
    """The launcher's result (``losses``, ``grad_norms``,
    ``step_seconds``, ``plan``) for ``argv`` (default ``sys.argv[1:]``)
    after the example's own arguments."""
    from ..launch import train

    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--arch") for a in argv):
        argv += ["--arch", "qwen2-0.5b"]
    if not any(a.startswith("--steps") for a in argv):
        argv += ["--steps", "200"]
    return train.main(["--reduced", "--batch", "16", "--seq", "64",
                       "--strategy", "auto", "--log-every", "25"] + argv)


if __name__ == "__main__":
    main()

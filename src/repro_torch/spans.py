"""Named phases of the training step and regions of the model, for
``torch.profiler``.

``span(name)`` marks a stretch of host code.  While a profiler records, it
is a ``torch.profiler.record_function`` range: the same kind of range a
caller's own ``record_function`` opens, so the profiler holds it in the
same trace, on the same clock as the device events it traces, and ties
each device operation to it through its launch's correlation id.
Otherwise it is one shared no-op context, and costs one flag check.
Nothing here records, buffers or writes anything of its own.

To see the phases, run any step under ``torch.profiler.profile`` and read
the ranges in its trace (``export_chrome_trace``) or ``key_averages()``:

* the step's phases (``distributed/train_step.py``): ``step.fwd``,
  ``step.bwd`` (once per micro-batch each), ``step.sync`` and inside it one
  ``sync.bucket`` per gradient bucket, ``step.clip``, ``step.update``;
* the model's regions (``models/``): ``model.attn`` (a block's first norm,
  its mixer, cross-attention and residual), ``model.ffn`` (its second
  norm, MLP, routed experts or channel mix, and residual), ``model.io``
  (the embedding, the stacked weights' per-layer views, the final norm
  and the cross-entropy chunks).

A device operation belongs to the innermost span open on the host thread
that launched it.  Under remat the recomputed forward runs inside
``step.bwd`` (on a GPU on autograd's own thread), and a block's
``model.attn`` and ``model.ffn`` open there again.  A backward operation
runs inside the evaluation of its autograd node, which carries in the
profiler's ``Sequence number`` the number of the node that the forward
operation it differentiates made; that ties it to the forward operation's
``model.*`` span.  So does a recomputed cross-entropy chunk, run inside
the evaluation of the node whose saved tensors it remakes.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else
    the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF

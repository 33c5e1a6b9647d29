"""The encoder-decoder (seamless-m4t-medium: an encoder over stub frame
embeddings, cross-attention over its output in every decoder layer,
sinusoidal positions) against the JAX reference, on the CPU at the
reduced config in f32, with the reference's weights and batch.

The shared cases of ``tests/test_torch_vlm.py`` run here on this file's
``arch``: the trees, the batch, forward and loss, gradients with remat,
prefill against the reference's flash, ``decode_step(memory=)`` stepping
equal to ``forward``, the trace, the launcher with a save and resume, and
``layout="tp"`` on a (2, 2) gloo mesh.  This file adds the encoder's own
cases."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

from test_torch_vlm import (_close, _setup,  # noqa: E402,F401
                            test_batch_matches_reference,
                            test_decode_steps_match_forward,
                            test_forward_and_loss_match_reference,
                            test_grads_with_remat_match_reference,
                            test_launcher_searches_saves_and_resumes,
                            test_prefill_matches_reference_flash,
                            test_tp_step_matches_one_rank_step,
                            test_trace_matches_reference,
                            test_tree_matches_reference)

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def arch():
    return ARCH


@pytest.mark.parametrize("model", ["stacked", "layers"])
def test_encode_matches_reference(model):
    """The encoder's output (the input projection, the sinusoid, the
    non-causal self-attention and MLP layers, the final norm) within
    1e-5."""
    jcfg, cfg, jst, jlay, st, lay, jbatch, batch = _setup(ARCH)
    JMM, MM, jp, p = ((JST, ST, jst, st) if model == "stacked"
                      else (JM, M, jlay, lay))
    want = JMM.encode(jp, jcfg, jbatch["enc_frames"])
    with torch.no_grad():
        got = MM.encode(p, cfg, batch["enc_frames"])
    assert got.shape == (2, cfg.encdec.enc_seq, cfg.d_model)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_decode_without_memory_skips_cross_attention():
    """``decode_step`` with no ``memory`` runs no cross-attention, as the
    reference's (and as both packages' engines serve the model); the
    per-layer model: after a
    prefill without frames, 2 steps' logits equal the reference's within
    2e-3, and differ from the steps that cross-attend."""
    jcfg, cfg, _, jlay, _, lay, jbatch, batch = _setup(ARCH)
    toks, jtoks = batch["tokens"], jbatch["tokens"]
    jl, jc = JM.prefill(jlay, jcfg, jtoks[:, :8], 32)
    with torch.no_grad():
        lg, caches = M.prefill(lay, cfg, toks[:, :8], 32)
        memory = M.encode(lay, cfg, batch["enc_frames"])
    _close(lg, jl, rtol=2e-3, atol=2e-3)
    for t in range(8, 10):
        jl, jc = JM.decode_step(jlay, jcfg, jc, jtoks[:, t], jnp.int32(t))
        with torch.no_grad():
            lg, caches = M.decode_step(lay, cfg, caches, toks[:, t], t)
            crossed, _ = M.decode_step(
                lay, cfg, [{k: v.clone() for k, v in c.items()}
                           for c in caches], toks[:, t], t, memory=memory)
        _close(lg, jl, rtol=2e-3, atol=2e-3)
        assert float((crossed - lg).abs().max()) > 1e-2

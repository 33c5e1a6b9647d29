"""The port's twins of ``examples/train_lm.py`` and
``examples/serve_decode.py`` on the CPU:

* ``repro_torch.examples.train_lm``: the launcher's arguments it adds
  (``--arch qwen2-0.5b`` and ``--steps 200`` only where argv lacks them),
  and a 3-step run of the searched strategy;
* ``repro_torch.examples.serve_decode`` on reduced tinyllama-1.1b and
  rwkv6-3b in f32 (batch 2, prompt 8, 6 new tokens), from the reference's
  weights (bridged): the prefill's and each step's logits within 1e-4 of
  the reference example's loop (``stacked.prefill``, then jit'd
  ``stacked.decode_step``), and the greedy tokens equal; and its CLI.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import materialize_batch as jax_batch  # noqa: E402
from repro.models import stacked as JST  # noqa: E402

from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import serve_decode, train_lm  # noqa: E402

B, PROMPT, NEW = 2, 8, 6
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("argv,want", [
    ([], ["--arch", "qwen2-0.5b", "--steps", "200"]),
    (["--arch", "rwkv6-3b"], ["--arch", "rwkv6-3b", "--steps", "200"]),
    (["--steps=7", "--device", "cpu"],
     ["--steps=7", "--device", "cpu", "--arch", "qwen2-0.5b"]),
])
def test_train_lm_argv(monkeypatch, argv, want):
    """The launcher gets the example's fixed arguments, then argv, then
    the defaults argv lacks."""
    from repro_torch.launch import train

    seen = []
    monkeypatch.setattr(train, "main", lambda a: seen.append(a) or {})
    train_lm.main(argv)
    assert seen == [["--reduced", "--batch", "16", "--seq", "64",
                     "--strategy", "auto", "--log-every", "25"] + want]


def test_train_lm_runs(capsys):
    """Three steps of reduced qwen2-0.5b under the searched Plan on the
    CPU: finite losses, a Plan covering every leaf."""
    out = train_lm.main(["--device", "cpu", "--steps", "3"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["plan"] is not None
    assert sorted(i for b in out["plan"].buckets for i in b) == \
        list(range(out["plan"].describe()["grad_tensors"]))
    assert "arch=qwen2-0.5b-reduced" in capsys.readouterr().out


def _reference_loop(jcfg, jparams, prompts):
    """The reference example's loop: the prefill's logits and each
    decode step's, and the greedy tokens."""
    prefill = jax.jit(lambda p, t: JST.prefill(p, jcfg, t, PROMPT + NEW))
    logits, caches = prefill(jparams, prompts)
    decode = jax.jit(
        lambda p, c, tok, pos: JST.decode_step(p, jcfg, c, tok, pos))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out_logits, out_tokens = [np.asarray(logits)], [np.asarray(tok)]
    for i in range(NEW):
        logits, caches = decode(jparams, caches, tok, jnp.int32(PROMPT + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out_logits.append(np.asarray(logits))
        out_tokens.append(np.asarray(tok))
    return out_logits, np.stack(out_tokens, 1)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_serve_decode_matches_reference(arch):
    """The twin's loop on the reference's weights: the prompts are the
    reference's, the logits of the prefill and of each step within 1e-4
    of the reference example's, the greedy tokens equal."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    assert cfg.dtype == jcfg.dtype == "float32"
    jparams = jax.jit(JST.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = jax_batch(jcfg, B, PROMPT)["tokens"]
    want_logits, want_tokens = _reference_loop(jcfg, jparams,
                                               jnp.asarray(prompts))
    out = serve_decode.decode(cfg, torch.device("cpu"), batch=B,
                              prompt_len=PROMPT, new_tokens=NEW,
                              params=params)
    assert len(out["logits"]) == NEW + 1
    for t, (got, want) in enumerate(zip(out["logits"], want_logits)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"step {t}",
                                   **TOL)
    np.testing.assert_array_equal(out["tokens"].numpy(), want_tokens)


def test_serve_decode_cli(capsys):
    """The CLI on the CPU: the reference's lines, the continuation of
    row 0 from its own tokens."""
    out = serve_decode.main(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "6"])
    assert tuple(out["tokens"].shape) == (2, 7)
    text = capsys.readouterr().out
    assert "prefill 2 prompts of 8 tokens" in text
    assert "decoded 12 tokens" in text
    assert str(out["tokens"][0].tolist()) in text

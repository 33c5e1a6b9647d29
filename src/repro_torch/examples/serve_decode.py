"""Batched serving: prefill a batch of prompts, then decode new tokens
greedily (port of ``examples/serve_decode.py``).

    python -m repro_torch.examples.serve_decode                # on the GPU
    python -m repro_torch.examples.serve_decode --device cpu --arch rwkv6-3b

A reduced model (weights from seed 0) prefills ``materialize_batch``'s
prompts into caches of prompt + new tokens, then runs one
``decode_step`` a token, each fed the token its logits pick.  On a GPU
the prefill runs through the kernels (flash attention, and the RG-LRU or
WKV-6 scan where the arch has one), as the port's serving engine does;
the reference example's prefill is kernel-free.  :func:`decode` takes a
config, so the same loop runs at full width.
"""
from __future__ import annotations

import argparse
import time


def decode(cfg, device, *, batch: int = 8, prompt_len: int = 32,
           new_tokens: int = 64, params=None) -> dict:
    """``batch`` prompts of ``prompt_len`` tokens of ``cfg`` prefilled on
    ``device`` into caches of ``prompt_len + new_tokens``, then
    ``new_tokens`` greedy decode steps, the prefill through the kernels
    on a GPU.  ``params`` default to ``init_params`` from seed 0.  Returns the picked tokens (batch, new_tokens + 1),
    the logits of the prefill and of each step, and the prefill's and
    the decode loop's seconds (host clock, the device synced)."""
    import torch

    from ..data.pipeline import materialize_batch
    from ..models import stacked as ST

    on_gpu = device.type == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize(device)

    if params is None:
        params = ST.init_params(cfg, seed=0, device=device)
    cache_len = prompt_len + new_tokens
    prompts = materialize_batch(cfg, batch, prompt_len,
                                device=device)["tokens"]
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, caches = ST.prefill(params, cfg, prompts, cache_len,
                                    use_kernels=on_gpu)
        sync()
        prefill_s = time.perf_counter() - t0
        tok = logits.argmax(-1)
        tokens, all_logits = [tok], [logits]
        t0 = time.perf_counter()
        for i in range(new_tokens):
            logits, caches = ST.decode_step(params, cfg, caches, tok,
                                            prompt_len + i)
            tok = logits.argmax(-1)
            tokens.append(tok)
            all_logits.append(logits)
        sync()
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(tokens, 1), "logits": all_logits,
            "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None) -> dict:
    from ..configs import ARCHS, get_config
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"prefill {args.batch} prompts of {args.prompt_len} tokens ...")
    out = decode(cfg, device, batch=args.batch, prompt_len=args.prompt_len,
                 new_tokens=args.new_tokens)
    print(f"  prefill {out['prefill_s']:.2f}s "
          f"({args.batch * args.prompt_len} tokens)")
    dt = out["decode_s"]
    total = args.batch * args.new_tokens
    print(f"  decoded {total} tokens in {dt:.2f}s "
          f"({total / dt:.0f} tok/s, {dt / args.new_tokens * 1e3:.1f} "
          f"ms/step)")
    print(f"  first sequence continuation: "
          f"{out['tokens'][0, :16].tolist()} ...")
    return out


if __name__ == "__main__":
    main()

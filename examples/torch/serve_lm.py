"""Serve a small LM with the PyTorch port: batched prefill + token-by-token
decode with the ring-buffer KV cache (local+global alternating config, like
gemma2); the counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]

Runs on ``--device`` (default ``cuda``; a missing card raises). The
weights are the port's own seeded draw, so the generated ids are not the
reference's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.train import train_loop as tl


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("gemma2-27b").smoke_config()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0))
    batch, prompt_len, gen_len = 4, 24, 16
    max_len = prompt_len + gen_len

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)
    ).to(dev)

    prefill = tl.make_lm_prefill_step(cfg, max_len=max_len)
    decode = tl.make_lm_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    for t in range(gen_len):
        out_tokens.append(tok.cpu().numpy())
        logits, cache = decode(params, tok, prompt_len + t, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = np.stack(out_tokens, 1)
    print(f"batch={batch} prompt={prompt_len} generated={gen_len}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms "
          f"({batch * prompt_len / t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode / gen_len * 1e3:.1f} ms/token "
          f"({batch * gen_len / t_decode:.0f} tok/s)")
    print("sample generations (token ids):")
    for b in range(min(batch, 2)):
        print(" ", gen[b][:12], "...")
    if gen.shape != (batch, gen_len) or not (
            np.all(gen >= 0) and np.all(gen < cfg.vocab)):
        raise SystemExit(f"bad generations {gen.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving launcher: batched prefill + greedy decode (LM) or CTR scoring
(recsys), the counterpart of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch gemma2-27b --smoke --tokens 16
    python -m repro_torch.launch.serve --arch din --smoke
    python -m repro_torch.launch.serve --arch gemma2-27b --prompt 8192 --batch 1

Runs on ``--device`` (default ``cuda``; a missing card raises — pass
``--device cpu`` to run the plain torch versions of the kernels). Weights
are random, drawn from a ``torch.Generator`` seeded with 0 on the device;
prompts and CTR batches are the reference's (numpy, seed 0). Prefill at a
prompt of ``cfg.flash_cutoff`` (8,192) tokens or more runs attention
through kernel B8. Every timed region ends in ``torch.cuda.synchronize()``
on the card, as the reference's ends in ``block_until_ready``; as there,
the prefill time includes whatever the first call builds. Prints the
reference's lines.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..configs.registry import get_arch
from ..device import resolve_device
from ..models import transformer as tfm
from ..train import train_loop as tl


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve_lm(arch_id: str, smoke: bool, batch: int, prompt: int, tokens: int,
             device="cuda", result: Optional[dict] = None):
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    cfg = arch.smoke_config() if smoke else arch.config()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(batch, prompt)).astype(np.int32)
    ).to(dev)
    max_len = prompt + tokens
    prefill = tl.make_lm_prefill_step(cfg, max_len=max_len)
    decode = tl.make_lm_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts)
    _sync(dev)
    tp = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for t in range(tokens):
        logits, cache = decode(params, tok, prompt + t, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    td = time.perf_counter() - t0
    print(f"[{arch_id}] prefill {tp * 1e3:.1f} ms | "
          f"decode {td / tokens * 1e3:.2f} ms/tok | "
          f"throughput {batch * tokens / td:.0f} tok/s")
    if result is not None:
        result.update(cfg=cfg, params=params, prompts=prompts,
                      prefill_logits=first, tokens=torch.stack(out, 1),
                      prefill_s=tp, decode_s=td)


@torch.inference_mode()
def serve_recsys(smoke: bool, batch: int, device="cuda",
                 result: Optional[dict] = None):
    from ..data.recsys import CTRStream
    from ..models.recsys import din

    dev = resolve_device(device)
    arch = get_arch("din")
    cfg = arch.smoke_config() if smoke else arch.config()
    params = din.init_params(cfg, torch.Generator(dev).manual_seed(0))
    stream = CTRStream(cfg.n_items, cfg.n_cats, batch, seq_len=cfg.seq_len,
                       d_profile=cfg.d_profile, seed=0)
    step = tl.make_recsys_serve_step(din.apply, cfg)

    def on_device(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}

    step(params, on_device(0))
    _sync(dev)
    # batches are on the device before the clock starts, and the clock
    # stops after the last step's output is ready
    n_iters = 3
    batches = [on_device(i) for i in range(1, 1 + n_iters)]
    _sync(dev)
    t0 = time.perf_counter()
    outs = [step(params, b) for b in batches]
    _sync(dev)
    dt = (time.perf_counter() - t0) / n_iters
    print(f"[din] {batch} reqs in {dt * 1e3:.1f} ms "
          f"({batch / dt:.0f} req/s)")
    if result is not None:
        result.update(cfg=cfg, params=params, batches=batches, probs=outs,
                      batch_s=dt)


def main(argv=None, result: Optional[dict] = None):
    """Serve once; returns the exit code. ``result``, when given, receives
    the config, the parameters, the inputs, the outputs and the timings."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch)
    if arch.family == "lm":
        serve_lm(args.arch, args.smoke, args.batch, args.prompt, args.tokens,
                 args.device, result)
    elif arch.family == "recsys":
        serve_recsys(args.smoke, max(args.batch, 8), args.device, result)
    else:
        raise SystemExit(f"{args.arch}: no serving path for {arch.family}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Train a small LM end to end with the PyTorch port's substrate: data
pipeline, AdamW, microbatching, async checkpointing, restart, straggler
monitor; the counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch/train_lm.py               # ~12M params
    PYTHONPATH=src python examples/torch/train_lm.py --size 100m --steps 300
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 20 --seq 64

Demonstrates fault tolerance: train, stop, then a second invocation with
``--resume`` continues from the newest checkpoint. Runs on ``--device``
(default ``cuda``; a missing card raises). The checkpoints go to
``--ckpt-dir`` (default: a directory under the system's temporary
directory).
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StragglerMonitor, TrainRunner
from repro_torch.models import transformer as tfm
from repro_torch.train import train_loop as tl
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import adamw, cosine_schedule

SIZES = {
    "12m": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_head=64,
                d_ff=1024, vocab=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                 d_head=64, d_ff=3072, vocab=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="12m", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.fresh and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)

    cfg = tfm.TransformerConfig(name=f"lm-{args.size}", remat=False,
                                dtype=torch.float32, **SIZES[args.size])
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params")

    opt = adamw(lr=cosine_schedule(3e-4, 20, args.steps), weight_decay=0.01)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    start_step = 0
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0))
    opt_state = opt.init(params)
    if args.resume and ckpt.latest_step() is not None:
        tmpl = {"params": params, "opt_state": opt_state}
        state, meta = ckpt.restore(tmpl, device=dev)
        params, opt_state = state["params"], state["opt_state"]
        start_step = meta["next_step"]
        print(f"resumed from step {start_step}")

    step_fn = tl.make_lm_train_step(cfg, opt, n_microbatches=2)
    runner = TrainRunner(
        step_fn=step_fn,
        data_fn=lambda s: {k: torch.as_tensor(v, device=dev)
                           for k, v in stream.batch_at(s).items()},
        ckpt=ckpt,
        ckpt_every=20,
        monitor=StragglerMonitor(),
    )
    params, opt_state, log = runner.run(
        params, opt_state, start_step=start_step,
        n_steps=args.steps - start_step,
        meta={"arch": cfg.name}, async_ckpt=True,
    )
    losses = [m["loss"] for m in log]
    print(f"steps {start_step}..{args.steps}: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    k = max(len(losses) // 5, 1)
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise SystemExit("loss did not improve")
    print("loss improved; straggler flags:", len(runner.monitor.flagged))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

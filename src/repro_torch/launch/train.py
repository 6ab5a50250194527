"""Training launcher, the counterpart of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 20
    python -m repro_torch.launch.train --arch din --smoke --steps 50 --device cpu
    python -m repro_torch.launch.train --arch gin-tu --steps 20
    python -m repro_torch.launch.train --arch gat-cora --steps 30 --device cpu
    python -m repro_torch.launch.train --arch pna --ckpt-dir ckpt --resume
    python -m repro_torch.launch.train --arch mace --steps 5 --device cpu

The launcher wires config -> model -> data stream -> optimizer ->
``TrainRunner`` (checkpoint/restart, straggler monitor); ``--resume``
continues from the newest checkpoint. Each family is wired as the
reference wires it, with parameters drawn from a ``torch.Generator``
seeded with ``--seed`` on the device (other draws than the reference's):

- lm: the full config, or the reduced one under ``--smoke``;
  ``adamw(lr=cosine_schedule(3e-4, min(20, steps // 4 + 1), steps))``;
  ``TokenStream(vocab, 4, 64, seed)``; 2 microbatches a step.
- recsys (DIN): the full config (a 10^8-row item table) or the reduced one
  under ``--smoke``; ``adamw(lr=1e-3, weight_decay=0.0)``;
  ``CTRStream(n_items, n_cats, 128, ...)``.
- gnn: the smoke config on ``make_smoke_batch``'s 48-node batch
  (``--smoke`` changes nothing for GNNs, in the reference too),
  ``adamw(lr=1e-3, weight_decay=0.0)``; the batch is put on the device and
  its edges sorted by destination once, for kernel B9. ``wire_gnn`` holds
  that wiring for any config and batch.

The streams' numpy batches are moved to the device as the runner asks for
them. The MoE LMs raise (their FFN is not ported yet). Runs on
``--device`` (default ``cuda``; a missing card raises — pass ``--device
cpu`` to run the plain torch versions of the kernels). Prints the
reference's line.
"""
from __future__ import annotations

import argparse
import importlib
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.inputs import make_smoke_batch
from ..configs.registry import get_arch
from ..data.recsys import CTRStream
from ..data.tokens import TokenStream
from ..device import resolve_device
from ..distributed.fault_tolerance import StragglerMonitor, TrainRunner
from ..models import transformer as tfm
from ..models.gnn.common import sort_edges_by_dst
from ..models.recsys import din
from ..train import train_loop as tl
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import adamw, cosine_schedule

GNN_MODULES = {
    "pna": "repro_torch.models.gnn.pna",
    "gin-tu": "repro_torch.models.gnn.gin",
    "gat-cora": "repro_torch.models.gnn.gat",
    "mace": "repro_torch.models.gnn.mace",
}


def wire_gnn(arch_id: str, cfg, batch, seed: int = 0, device="cuda"):
    """(params, optimizer, step, data_fn) for the GNN ``arch_id`` on
    ``cfg`` and ``batch`` (numpy arrays or tensors), wired as the reference
    wires it: parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``, ``adamw(lr=1e-3, weight_decay=0.0)``, the batch
    moved to ``device`` and its edges sorted by destination once, for
    kernel B9. ``data_fn`` hands out that one batch at every step."""
    dev = resolve_device(device)
    mod = importlib.import_module(GNN_MODULES[arch_id])
    optim = adamw(lr=1e-3, weight_decay=0.0)
    params = mod.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    batch = sort_edges_by_dst(
        {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    step = tl.make_gnn_train_step(mod.apply, cfg, optim)
    return params, optim, step, lambda s: batch


def _on_device(batch_at: Callable, dev) -> Callable:
    """A stream's ``batch_at`` with its numpy arrays moved to ``dev``."""
    return lambda step: {k: torch.as_tensor(v, device=dev)
                         for k, v in batch_at(step).items()}


def build(arch_id: str, seed: int, device="cuda", *, smoke: bool = False,
          steps: int = 20):
    """(params, optimizer, step, data_fn) for ``arch_id`` on ``device``,
    wired as the reference's ``build`` wires it (see the module
    docstring)."""
    arch = get_arch(arch_id)
    if arch.family not in ("lm", "recsys", "gnn"):
        raise ValueError(f"--arch {arch_id}: family {arch.family} has no "
                         f"train step (use lcc_run for paper-lcc)")
    dev = resolve_device(device)
    if arch.family == "gnn":
        cfg, batch = make_smoke_batch(arch_id, "gnn_train",
                                      np.random.default_rng(seed))
        return wire_gnn(arch_id, cfg, batch, seed, device)
    cfg = arch.smoke_config() if smoke else arch.config()
    gen = torch.Generator(dev).manual_seed(seed)
    if arch.family == "lm":
        optim = adamw(lr=cosine_schedule(3e-4, min(20, steps // 4 + 1),
                                         steps))
        params = tfm.init_params(cfg, gen)
        stream = TokenStream(cfg.vocab, 4, 64, seed=seed)
        step = tl.make_lm_train_step(cfg, optim, n_microbatches=2)
        return params, optim, step, _on_device(stream.batch_at, dev)
    optim = adamw(lr=1e-3, weight_decay=0.0)
    params = din.init_params(cfg, gen)
    stream = CTRStream(cfg.n_items, cfg.n_cats, 128, seq_len=cfg.seq_len,
                       d_profile=cfg.d_profile, seed=seed)
    step = tl.make_recsys_train_step(din.apply, cfg, optim)
    return params, optim, step, _on_device(stream.batch_at, dev)


def main(argv=None, result: Optional[dict] = None):
    """Train; returns the exit code. ``result``, when given, receives the
    final parameters and optimizer state and the per-step log."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (lm, recsys); GNNs always "
                         "train the smoke config, as in the reference")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    params, optim, step, data_fn = build(args.arch, args.seed, args.device,
                                         smoke=args.smoke, steps=args.steps)
    opt_state = optim.init(params)
    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and ckpt and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(
            {"params": params, "opt_state": opt_state},
            device=resolve_device(args.device),
        )
        params, opt_state = state["params"], state["opt_state"]
        start = meta["next_step"]
        print(f"resumed from step {start}")

    runner = TrainRunner(step_fn=step, data_fn=data_fn, ckpt=ckpt,
                         ckpt_every=args.ckpt_every,
                         monitor=StragglerMonitor())
    params, opt_state, log = runner.run(
        params, opt_state, start_step=start, n_steps=args.steps - start,
        meta={"arch": args.arch},
    )
    print(f"[{args.arch}] loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f} "
          f"over {len(log)} steps "
          f"({np.mean([m['dt'] for m in log]) * 1e3:.0f} ms/step)")
    if result is not None:
        result.update(params=params, opt_state=opt_state, log=log)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

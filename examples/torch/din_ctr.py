"""DIN recsys end to end with the PyTorch port: train on the synthetic CTR
stream (zipf item popularity — the paper's power-law reuse structure),
then serve and run candidate retrieval; the counterpart of
``examples/din_ctr.py``.

    PYTHONPATH=src python examples/torch/din_ctr.py [--device cpu]

Runs on ``--device`` (default ``cuda``; a missing card raises), with the
port's own seeded weights.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.recsys import CTRStream
from repro_torch.device import resolve_device
from repro_torch.models.recsys import din
from repro_torch.train import train_loop as tl
from repro_torch.train.optimizer import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def on_device(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    cfg = get_arch("din").smoke_config()
    params = din.init_params(cfg, torch.Generator(dev).manual_seed(0))
    opt = adamw(lr=2e-3, weight_decay=0.0)
    opt_state = opt.init(params)
    stream = CTRStream(cfg.n_items, cfg.n_cats, batch=256,
                       seq_len=cfg.seq_len, d_profile=cfg.d_profile, seed=0)
    step = tl.make_recsys_train_step(din.apply, cfg, opt)

    losses = []
    for i in range(args.steps):
        params, opt_state, m = step(params, opt_state,
                                    on_device(stream.batch_at(i)))
        losses.append(float(m["loss"]))
    print(f"train BCE: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise SystemExit("DIN did not learn")

    # serving
    serve = tl.make_recsys_serve_step(din.apply, cfg)
    batch = on_device(stream.batch_at(999))
    with torch.inference_mode():
        probs = serve(params, batch).cpu().numpy()
    # AUC-ish check: positives should score higher on average
    lab = batch["label"].cpu().numpy()
    print(f"serve: mean p(click|pos)={probs[lab > 0].mean():.3f} "
          f"p(click|neg)={probs[lab == 0].mean():.3f}")

    # retrieval: one user vs 4096 candidates
    rng = np.random.default_rng(1)
    rb = {
        "hist_items": batch["hist_items"][:1],
        "hist_cats": batch["hist_cats"][:1],
        "hist_mask": batch["hist_mask"][:1],
        "user_profile": batch["user_profile"][:1],
        "cand_items": torch.as_tensor(
            rng.integers(0, cfg.n_items, 4096).astype(np.int32), device=dev),
        "cand_cats": torch.as_tensor(
            rng.integers(0, cfg.n_cats, 4096).astype(np.int32), device=dev),
    }
    retr = tl.make_retrieval_step(din.retrieval_score, cfg, top_k=10)
    vals, idx = retr(params, rb)
    print("retrieval top-10 candidate ids:", idx.cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

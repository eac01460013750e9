"""End-to-end driver through the PyTorch port: train a ~100M-parameter LM
for a few hundred steps (``examples/train_lm.py`` through ``repro_torch``).

The same config, train_step, data pipeline and printed lines as the JAX
example, on the card unless ``--device`` names another.  Loss drops from
~ln(V) to well below it within the run — the optimization path is real.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.core.state import resolve_device
from repro_torch.data import DataState, make_batch_iterator
from repro_torch.models.model import get_config, param_count
from repro_torch.train import make_train_step, train_state_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a ~100M-param member of the assigned family (musicgen-medium scaffold)
    cfg = dataclasses.replace(
        get_config("musicgen-medium"),
        num_layers=8, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=8192, frontend=None,
        frontend_len=0, dtype="float32",
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = train_state_init(gen, cfg)
    print(f"model: {param_count(state.params)/1e6:.1f}M params")

    step_fn = make_train_step(
        cfg, lr=3e-4, warmup=50, total_steps=args.steps, loss_chunk=128
    )
    it = make_batch_iterator(
        cfg.vocab_size, args.seq, args.batch, state=DataState(seed=0), device=dev
    )
    t0, first_loss = time.time(), None
    for step, batch in it:
        if step >= args.steps:
            break
        state, m = step_fn(state, batch)
        if step % 25 == 0 or step == args.steps - 1:
            loss = float(m["loss"])
            first_loss = first_loss or loss
            tok_s = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:4d}  loss {loss:.4f}  ({tok_s:,.0f} tok/s)", flush=True)
    last_loss = float(m["loss"])
    print(f"loss: {first_loss:.3f} → {last_loss:.3f} ✓")
    return first_loss, last_loss


if __name__ == "__main__":
    main()

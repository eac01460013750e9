"""Training driver (port of ``repro/launch/train.py``).

Fault-tolerance behaviors:
  * resume-from-latest on start (idempotent restarts — preemption safe),
  * async checkpointing every ``--ckpt-every`` steps (atomic commit),
  * elastic restore: the checkpoint stores logical PartitionSpecs, so the
    same command line restores onto a different ``--mesh`` after rescale,
  * the data iterator step rides in the checkpoint manifest.

Usage (CPU example, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

The reference's flags plus ``--device`` (default: the card).  ``--mesh
DxM`` builds ``make_host_mesh(D, M)`` over the devices of ``--device``'s
kind, which, as in the reference, becomes ``(n, 1)`` when D x M exceeds
the n devices that exist: on one card or on the host every mesh trains at
1 x 1.  The state is placed by ``sharding.param_specs`` and the step runs
through ``sharding.Jitted`` with the state donated.  The host waits on the
card only at log steps (the loss line) and checkpoints (the copy to host
memory).  :func:`main` returns the final ``TrainState``, its leaves
whole on the mesh's first device.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import sharding as sh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.state import resolve_device
from repro_torch.data import DataState, make_batch_iterator
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import get_config
from repro_torch.optim import AdamWState
from repro_torch.sharding import P
from repro_torch.train import TrainState, make_train_step, train_state_init


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1", help="dataxmodel, e.g. 4x2")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card; 'cpu' runs on the host)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = make_host_mesh(d, m, dev)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    cfg = cfg.padded(int(mesh.shape["model"]))

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    state = train_state_init(gen, cfg)
    pspecs = sh.param_specs(cfg, state.params, int(mesh.shape["model"]))
    state_specs = TrainState(params=pspecs, opt=AdamWState(step=P(), m=pspecs, v=pspecs))
    state = sh.place(state, state_specs, mesh)

    data_state = DataState(seed=args.seed)
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        step0, restored, extra = mgr.restore_latest(state, mesh=mesh, specs=state_specs)
        if step0 is not None:
            state = restored
            data_state.next_step = extra.get("data_step", step0)
            print(f"resumed from step {step0}")

    it = make_batch_iterator(cfg.vocab_size, args.seq, args.batch, state=data_state,
                             device=dev)
    step_fn = make_train_step(
        cfg,
        lr=args.lr,
        total_steps=args.steps,
        loss_chunk=min(512, args.seq),
    )
    batch_specs = {"tokens": sh.batch_spec(mesh), "targets": sh.batch_spec(mesh)}
    jstep = sh.Jitted(step_fn, mesh, (state_specs, batch_specs),
                      out_specs=(state_specs, P()), donate_argnums=(0,))
    t0 = time.time()
    for step, batch in it:
        if step >= args.steps:
            break
        state, metrics = jstep(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:.4f} ({dt:.1f}s)", flush=True)
        if mgr and step and step % args.ckpt_every == 0:
            mgr.save(step, state, specs=state_specs,
                     extra={"data_step": data_state.next_step})
    if mgr:
        mgr.save(args.steps, state, specs=state_specs,
                 extra={"data_step": data_state.next_step})
        mgr.wait()
    print("done")
    return sh.whole(state)


if __name__ == "__main__":
    main()

"""Training launcher of the port (port of ``repro/launch/train.py``): the
train step on a ``(data, model)`` mesh of ranks, the deterministic corpus,
async checkpoints, the heartbeat monitor and resume from the latest
checkpoint, elastic onto a mesh of another shape.

    python -m repro_torch.launch.train --arch smollm-135m --steps 200 \\
        --batch 8 --seq 256 --ckpt-dir /tmp/ckpt            # on the GPU
    python -m repro_torch.launch.train --reduced --steps 5 --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \\
        --data 2 --model 2 --device cpu --steps 3

Under torchrun every rank joins the mesh (NCCL on ``cuda:{LOCAL_RANK}``,
gloo with ``--device cpu``); params and AdamW moments are stored sharded
under the reference's FSDP specs, every rank draws the whole batch and
takes its rows, and only rank 0 prints. A lone process clamps
``--data``/``--model`` to its one device, as the reference clamps them to
the devices there are. On a CUDA device the loss runs under bf16 autocast
(the reference computes in bf16 off the CPU); on the CPU in f32. Params
and optimizer moments are f32 throughout. A checkpoint holds the whole
``TrainState`` in the reference's layout (``--ckpt-dir``; ``save_async``
every ``--ckpt-every`` steps), so either package resumes the other's, on
any mesh, and ``python -m repro_torch.launch.serve --ckpt-dir DIR``
quantizes and serves the trained weights.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.ft.monitor import HeartbeatMonitor
from repro_torch.launch.mesh import local_mesh, make_host_mesh
from repro_torch.models.layers import Runtime
from repro_torch.sharding import rules as rules_mod
from repro_torch.train import loop as train_loop
from repro_torch.train import sharded


def build_trainer(cfg, mesh, *, num_micro: int = 1, lr: float = 3e-4,
                  total_steps: int = 1000):
    """``(train_step, state_specs, rules)`` of ``cfg`` on ``mesh`` (a
    ``launch/mesh.py`` Mesh), as the reference returns ``(jitted, named,
    rules)``: remat "dots", MoE capacity factor 2.0, bf16 autocast on a
    CUDA device and f32 on the CPU, the state stored under
    ``state_specs`` (``param_pspecs`` with FSDP; the step counters
    replicated) and the batch split by ``batch_pspec``."""
    rules = rules_mod.make_rules(mesh, cfg)
    specs = train_loop.state_specs(cfg, rules)
    compute = (torch.bfloat16 if mesh.device.type == "cuda"
               else torch.float32)
    step = train_loop.make_train_step(
        cfg, Runtime(capacity_factor=2.0), lr_peak=lr,
        total_steps=total_steps, num_micro=num_micro, compute_dtype=compute,
        mesh=mesh, specs=specs)
    return step, specs, rules


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; nothing falls back")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the launcher trains on the GPU unless "
                 "--device cpu is passed")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:  # under torchrun
        mesh = make_host_mesh(args.data, args.model, device=(
            None if device.type == "cuda" else device))
    else:  # a lone process: (data, model) clamped to its one device
        mesh = local_mesh(device)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} mesh={mesh.shape} devices={mesh.size} "
        f"({mesh.device.type})")
    step_fn, specs, _ = build_trainer(cfg, mesh, num_micro=args.micro,
                                      lr=args.lr, total_steps=args.steps)
    places = sharded.placements(specs, mesh)

    state = train_loop.init_train_state(cfg, seed=0, device=mesh.device,
                                        mesh=mesh, specs=specs)
    start = 0
    if args.ckpt_dir and ckpt_mod.latest_step(args.ckpt_dir) is not None:
        state, start = ckpt_mod.restore(args.ckpt_dir, state,
                                        shardings=places)
        say(f"resumed from step {start} (elastic onto {mesh.shape})")

    corpus = SyntheticCorpus(cfg.vocab_size, seed=17)
    monitor = HeartbeatMonitor(num_hosts=mesh.size)
    t0 = time.time()
    for step in range(start, args.steps):
        # the global batch on every rank (shard 0 of 1, as the reference's
        # single controller draws it); the step takes this rank's rows
        batch = corpus.batch(step, args.batch, args.seq)
        state, metrics = step_fn(state, batch)
        monitor.beat(mesh.rank, step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            say(f"step {step:5d} loss {m['loss']:.4f} gnorm "
                f"{m['gnorm']:.3f} lr {m['lr']:.2e} "
                f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_mod.save_async(args.ckpt_dir, step + 1, state,
                                shardings=places)
    if args.ckpt_dir:
        # the last async write of this step must land before the final
        # save renames the same directory
        ckpt_mod.wait_pending()
        ckpt_mod.save(args.ckpt_dir, args.steps, state, shardings=places)
    if monitor.stragglers():
        say("stragglers detected:", monitor.stragglers())
    say("done.")
    if mesh.size > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
